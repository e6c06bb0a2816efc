"""The PPO family across ranks on the CPU: R = 2 gloo ranks, each holding
half the arenas, against one rank holding them all
(`tests/torch_dist_worker.py` `family:<case>` and `sdf` jobs; the ranks are
subprocesses that import only the port, the one-rank references run here).

Each case is one iteration from a seed through `harness.build` (8 arenas,
8 steps over 6-step episodes, so resets draw mid-rollout; 2 minibatches,
1 epoch): ppo, ppo with the privileged branches (Hover's dr_* ranges),
ppo_tconv (a 16-step history), ppo_rnn (4-step chunks; the chunk
permutation injected, global over the 16 chunks of both ranks),
transformer (HideAndSeek), ppo_vision with the conv backbone and with
MobileNetV3-Small (16 x 12 depth frames; its batch statistics over every
rank's frames).  The bounds of tests/test_torch_parallel_train.py: the
ranks' trajectories joined within 1e-6 of each field's scale of the
one-rank trajectory (measured: identical but MobileNet's, 2.8e-7: its
statistics sum the two ranks' partial sums; 2.8e-2 with per-rank
statistics), the generators' states equal to the one-rank run's after the
rollout and after the update (ppo_rnn's part after the first step where
its noise is drawn at the rank's width), the first minibatch's actor and
critic gradients within 1e-5 of each one's scale (measured: at most
2.6e-6), the learner after the iteration within 3e-3 absolute (measured:
4.2e-4, MobileNet) and every metric within 2e-3 relative (+1e-5; measured
3.0e-5); the two ranks' learners are bit-identical.  ppo_sdf at policy
level: `train_op` on a synthetic trajectory with `sdf_points`, under the
same bounds.
"""
import numpy as np
import pytest

import torch_dist_worker as w

CASES = list(w.FAMILY)
JOBS = [f"family:{c}" for c in CASES] + ["sdf"]
TRAJ_REL, GRAD_REL, PARAM_ATOL, METRIC_REL = 1e-6, 1e-5, 3e-3, 2e-3


def _inputs():
    rng = np.random.default_rng(0)
    n_chunk = w.FAMILY_ALGO["train_every"] // w.FAMILY["ppo_rnn"][3]["train_seq_len"]
    return {"family:ppo_rnn/perms": rng.permutation(n_chunk * w.FAMILY_ENV["num_envs"])[None],
            "sdf/perms": rng.permutation(w.SDF_T * w.SDF_E)[None]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inp = _inputs()
    ranks = w.launch(2, JOBS, inp, tmp_path_factory.mktemp("parallel_family"), timeout=300.0)
    one = w.run_jobs(JOBS, inp, 0, 1)
    return ranks, one


def _hold_learner(ranks, one, job):
    a, b = ranks[0][job], ranks[1][job]
    for k in a:
        if k.startswith(("ts/", "metrics/")):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    want = one[job]
    grads = sorted({k.rsplit("/", 1)[0] for k in want if k.startswith("grad/")},
                   key=lambda g: int(g.split("/")[1]))
    # the first minibatch's steps: the actor's, then the critic's
    for g in grads[:2]:
        for k in (k for k in want if k.startswith(g + "/")):
            scale = float(np.abs(want[k]).max())
            assert float(np.abs(a[k] - want[k]).max()) <= GRAD_REL * scale + 1e-12, k
    for k in want:
        if k.startswith("ts/") and np.issubdtype(want[k].dtype, np.floating):
            assert a[k].shape == want[k].shape, k
            assert float(np.abs(a[k] - want[k]).max(initial=0.0)) <= PARAM_ATOL, k
        if k.startswith("metrics/"):
            np.testing.assert_allclose(a[k], want[k], rtol=METRIC_REL, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_family_ranks_equal_one_rank(runs, case):
    ranks, one = runs
    job = f"family:{case}"
    want = one[job]
    assert want["traj/done"].any()  # a reset inside the rollout
    for k in (k for k in want if k.startswith("traj/")):
        got = np.concatenate([r[job][k] for r in ranks], axis=1).astype(np.float64)
        ref = want[k].astype(np.float64)
        assert got.shape == ref.shape, k
        assert float(np.abs(got - ref).max()) <= TRAJ_REL * max(1.0, float(np.abs(ref).max())), k
    for key in ("gen_rollout", "gen"):
        for r in ranks:
            np.testing.assert_array_equal(r[job][key], want[key], err_msg=key)
    _hold_learner(ranks, one, job)
    for k in (k for k in want if k.startswith("ep_stats/")):
        np.testing.assert_allclose(ranks[0][job][k], want[k], rtol=METRIC_REL, atol=1e-5)


def test_sdf_update_ranks_equal_one_rank(runs):
    ranks, one = runs
    _hold_learner(ranks, one, "sdf")
