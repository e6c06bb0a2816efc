"""Data parallelism over the arena axis on the CPU: R = 2 gloo ranks, each
holding half the arenas, against one rank holding them all
(`tests/torch_dist_worker.py` runs the jobs; the ranks are subprocesses
that import only the port, the one-rank references run here).

* One HideAndSeek iteration with the TP net (8 arenas, 8 steps over 6-step
  episodes, so a reset draws a fresh scene mid-rollout; 2 minibatches, 1
  epoch): the ranks' trajectories joined equal the one-rank trajectory
  within 1e-6 of each field's scale (both sides round at the same points,
  row by row; measured: identical), the generators' states equal across
  ranks and the one-rank run's, before and after the update; the
  gradients of the TP step and of the first minibatch's actor and critic
  steps within 1e-5 of each leaf's scale (the sums run in another order:
  measured 1.4e-7); later steps start from parameters that Adam moved by
  about +-lr wherever a gradient is rounding noise, so the learner after the
  iteration is held to the JAX package's one-iteration bound, 3e-3
  absolute (tests/test_pack_rollout.py), and every metric within
  tests/test_torch_train_iter.py's 2e-3 relative (+1e-5).  The two ranks'
  learners are bit-identical.
* AEG (8 arenas, 4-step episodes, a 12-task buffer full of easy cases,
  r_min = 0): 13 steps close a cycle on the FPS path and draw a new task
  set; the replicated buffer is bit-identical on both ranks and equal to
  the one-rank buffer, each rank ran FPS once.
* The host-branch trap: rank 0's arenas end an episode and rank 1's do
  not (HideAndSeek and Hover); no rank hangs, the generators stay equal
  and the state equals the one-rank run's.
* `harness.train` on Hover in 2 processes (the JAX package's
  tests/multihost_worker.py argv, with a checkpoint each iteration): both
  exit 0 with identical finite losses; a one-rank `resume_dir` from the
  gathered checkpoint of iteration 1 continues as the 2-rank run does: the
  generator's state and the env state equal (within 1e-6), the parameters
  and the value normaliser within the one-iteration bound, the Adam counts
  equal (the moments follow the gradients, which part after the first
  step, as above); algo=ppo trains at 2 ranks, with identical finite
  losses on both; and the refusals across ranks (algo=ppo_adapt:
  NotImplementedError naming the JAX package's one-device train_rma; 15
  arenas over 2 ranks: ValueError).
"""
import math

import numpy as np
import pytest
import torch

import torch_dist_worker as w
from mupe_tpu_torch.harness import train
from mupe_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)
JOBS = ["iteration", "aeg", "trap", "harness"]
TRAJ_REL, GRAD_REL, PARAM_ATOL, METRIC_REL = 1e-6, 1e-5, 3e-3, 2e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_train")
    inp = {"harness/run_dir": np.asarray(str(tmp / "runs"))}
    ranks = w.launch(2, JOBS, inp, tmp / "ranks")
    one = w.run_jobs(["iteration", "aeg", "trap"], {}, 0, 1)
    return dict(ranks=ranks, one=one, run_dir=tmp / "runs", tmp=tmp)


def _joined(ranks, job, key, axis):
    return np.concatenate([r[job][key] for r in ranks], axis=axis)


def _ranks_identical(ranks, job, prefix=""):
    a, b = ranks[0][job], ranks[1][job]
    keys = [k for k in a if k.startswith(prefix)]
    assert keys and set(keys) == {k for k in b if k.startswith(prefix)}
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_ranks_equal_one_rank_trajectory(runs):
    one, ranks = runs["one"]["iteration"], runs["ranks"]
    keys = [k for k in one if k.startswith("traj/")]
    assert any(k.endswith("/done") for k in keys)
    assert one["traj/done"].any()  # a reset inside the rollout
    for k in keys:
        got = _joined(ranks, "iteration", k, axis=1).astype(np.float64)
        want = one[k].astype(np.float64)
        assert got.shape == want.shape, k
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= TRAJ_REL * scale, k


def test_ranks_share_the_one_rank_generator(runs):
    one, ranks = runs["one"]["iteration"], runs["ranks"]
    for key in ("gen_rollout", "gen"):
        for r in ranks:
            np.testing.assert_array_equal(r["iteration"][key], one[key], err_msg=key)


def test_ranks_equal_one_rank_gradients_and_learner(runs):
    one, ranks = runs["one"]["iteration"], runs["ranks"]
    _ranks_identical(ranks, "iteration", "ts/")
    _ranks_identical(ranks, "iteration", "metrics/")
    got = ranks[0]["iteration"]
    # the TP step, then the first minibatch's actor [flat, log_std] and critic
    for key in ("grad/0/0", "grad/0/1", "grad/0/2", "grad/0/3", "grad/0/4", "grad/1/0",
                "grad/1/1", "grad/2/0"):
        scale = float(np.abs(one[key]).max())
        assert float(np.abs(got[key] - one[key]).max()) <= GRAD_REL * scale + 1e-12, key
    for k in one:
        if k.startswith("ts/") and k.split("/")[1] in ("actor", "critic", "log_std", "tp_net"):
            assert float(np.abs(got[k] - one[k]).max()) <= PARAM_ATOL, k
    for k in one:
        if k.startswith(("metrics/", "ep_stats/")):
            np.testing.assert_allclose(got[k], one[k], rtol=METRIC_REL, atol=1e-5, err_msg=k)


def test_aeg_buffer_is_replicated_and_equals_one_rank(runs):
    one, ranks = runs["one"]["aeg"], runs["ranks"]
    assert int(one["fps_calls"]) == 1 and int(one["gb/history_len"]) == 12
    _ranks_identical(ranks, "aeg", "gb/")
    for r in ranks:
        assert int(r["aeg"]["fps_calls"]) == 1
        np.testing.assert_array_equal(r["aeg"]["gen"], one["gen"])
        for k in one:
            if k.startswith("gb/"):
                np.testing.assert_array_equal(r["aeg"][k], one[k], err_msg=k)
    np.testing.assert_array_equal(_joined(ranks, "aeg", "cylinders", 0), one["cylinders"])


@pytest.mark.parametrize("env", ["hideandseek", "hover"])
def test_one_ranks_reset_draws_on_every_rank(runs, env):
    one, ranks = runs["one"]["trap"], runs["ranks"]
    progress = _joined(ranks, "trap", f"{env}/progress", 0)
    np.testing.assert_array_equal(progress, [1] * 4 + [2] * 4)  # the first half reset
    for r in ranks:
        np.testing.assert_array_equal(r["trap"][f"{env}/gen"], one[f"{env}/gen"])
    np.testing.assert_array_equal(_joined(ranks, "trap", f"{env}/pos", 0), one[f"{env}/pos"])


def test_two_process_train_replicates_the_learner(runs):
    a, b = (r["harness"] for r in runs["ranks"])
    for k in ("metrics/policy_loss", "metrics/value_loss"):
        assert math.isfinite(float(a[k])) and float(a[k]) == float(b[k]), k
    assert float(a["metrics/env_frames"]) == 2 * 16 * 8  # global arenas x steps x iterations


def test_gathered_checkpoint_resumes_exactly_at_two_ranks(runs):
    """Iteration 2 resumed at 2 ranks from the gathered checkpoint of
    iteration 1: the same bits as the 2-rank run's own iteration 2."""
    ckpt = runs["run_dir"]
    for sub in ("", "full"):
        got = load_checkpoint(ckpt / "resumed" / "checkpoints" / sub)
        want = load_checkpoint(ckpt / "shared" / "checkpoints" / sub / "step_2")
        _assert_equal_trees(got, want)
    for r in runs["ranks"]:
        assert float(r["harness"]["resumed/policy_loss"]) == float(
            r["harness"]["metrics/policy_loss"])


def _assert_equal_trees(a, b, path=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_equal_trees(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_equal_trees(u, v, f"{path}[{i}]")
    else:
        assert a == b, path


def test_refused_across_ranks(runs):
    a, b = (r["harness"] for r in runs["ranks"])
    for r in (a, b):
        assert list(r["refused"]) == ["trained", "NotImplementedError", "ValueError",
                                      "ValueError"]
        assert "train_rma" in str(r["refused_messages"][1])
    for k in ("algo=ppo/policy_loss", "algo=ppo/value_loss"):
        assert math.isfinite(float(a[k])) and float(a[k]) == float(b[k]), k


def test_gathered_checkpoint_resumes_at_one_rank(runs):
    ckpt = runs["run_dir"] / "shared" / "checkpoints"
    m = train([*w.HARNESS_ARGV[:2], "max_iters=1", *w.HARNESS_ARGV[3:],
               f"run_dir={runs['tmp'] / 'resumed'}", "run_name=one",
               f"resume_dir={ckpt / 'full' / 'step_1'}"], default_task="Hover", device="cpu")
    assert math.isfinite(m["policy_loss"])
    got = load_checkpoint(runs["tmp"] / "resumed" / "one" / "checkpoints" / "full")
    want = load_checkpoint(ckpt / "full" / "step_2")
    assert torch.equal(got["generator"], want["generator"])

    def walk(g, v, path):
        if isinstance(v, dict):
            for k in v:
                walk(g[k], v[k], f"{path}.{k}")
        elif isinstance(v, list):
            for i, (x, y) in enumerate(zip(g, v)):
                walk(x, y, f"{path}[{i}]")
        elif isinstance(v, torch.Tensor):
            assert g.shape == v.shape, path
            if path.startswith(".ts") and ("_opt.mu" in path or "_opt.nu" in path):
                return  # the moments follow the gradients, which part after step 1
            if v.is_floating_point() and v.numel():
                tol = PARAM_ATOL if path.startswith(".ts") else TRAJ_REL * max(
                    1.0, float(v.abs().max()))
                assert float((g - v).abs().max()) <= tol, path
            elif not v.is_floating_point():
                assert torch.equal(g, v), path

    walk(got, want, "")
