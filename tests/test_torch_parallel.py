"""The port's data parallelism (`mupe_tpu_torch/parallel`) on the CPU: the
sharded update in 2 gloo ranks against the JAX package's one-device update,
the shard's draws and collectives, the refusals, and world size 1 with a
group against no group.

The sharded update: the same trajectory, learner and minibatch
permutations go through the JAX package's `train_op` (or `_update_tp`) and
through the port's, run by 2 subprocess ranks that each hold half the
arenas (`tests/torch_dist_worker.py`, which imports only the port), and by
one rank here.  Paths:

* "joint", "fwdloss", "agrad": MAPPO's joint update over dict observations
  (tests/test_torch_inkernel_loss.py's case: 10 arenas x 4 steps, 2
  agents, 2 epochs x 2 minibatches), the default path and the in-kernel
  loss in both direct modes (the CPU runs their plain versions), each held
  to the JAX package's joint update (`_update_joint_flat`, which the
  in-kernel loss computes too: tests/test_torch_inkernel_loss.py holds the
  two to one another).  The second epoch's permutation is made so that
  its first minibatch holds rank 0's arenas only and its second rank 1's:
  a rank owns no row of a minibatch (the JAX package is handed the same
  permutations).  Tolerances: tests/test_torch_train_iter.py's for a whole
  update against the JAX package's joint path (metrics within 2e-3
  relative, gradient norms 1e-2, +1e-5; parameters 3e-3 absolute, the key
  bias, whose gradient is rounding noise, 4e-3: Adam moves a parameter by
  about +-lr = 5e-4 a step whatever its gradient's size).
* "flat": Hover's flat observations, float32 (tests/test_torch_flat_mappo.py's
  `train_op` case: 16 arenas x 8 steps, JAX's own permutations), held to
  that file's float32 tolerances (parameters 2e-6, moments 3e-6 of the
  largest, metrics 1e-4 relative); "flat_empty": the same with the made
  permutations, the 2 ranks against the port's one rank.
* "tp": the TP net's step (tests/test_torch_update.py's case, 16 arenas x
  12 steps), held to that file's tolerances: TP_loss within 1e-5
  relative, the gradients within 3e-2 of each leaf's scale.

On every path the two ranks' learners are bit-identical, and the first
optimizer step's gradients are within 1e-4 of the gradient vector's scale
of the one-rank port's: the ranks' sums run in another order, and on the
dict paths the plain backward rounds to bf16 after some of them (measured
up to 1.9e-5 there, 1e-7 elsewhere).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mupe_tpu.ops.fused_encoder as jfe
import mupe_tpu.ops.tp_lstm as jtl
import torch_dist_worker as w
from mupe_tpu.learning.mappo import MAPPOCfg as JCfg
from mupe_tpu.learning.mappo import MAPPOPolicy as JPolicy
from mupe_tpu.learning.mappo import RolloutBatch, pack_rollout_row
from mupe_tpu_torch import bridge
from mupe_tpu_torch.learning import MAPPOCfg, MAPPOPolicy
from mupe_tpu_torch.ops import fused_encoder as fe
from mupe_tpu_torch.parallel import dist
from test_torch_flat_mappo import _hold_f32_update, _jax_update, _policies
from test_torch_flat_mappo import _port_state as _flat_port_state
from test_torch_inkernel_loss import A, DIMS, N_AG, INFO_KEYS, _make_case, _trajectory
from test_torch_train_iter import KEY_BIAS_ATOL, METRIC_REL, NORM_REL, PARAM_ATOL
from test_torch_update import GRAD_REL, pair  # noqa: F401  (the TP case's fixture)

torch.set_num_threads(1)
FLAGS = dict(train_every=4, num_minibatches=2, ppo_epochs=2)
JOINT = {"joint": {}, "fwdloss": dict(use_inkernel_loss=True, direct_mode="fwdloss"),
         "agrad": dict(use_inkernel_loss=True, direct_mode="agrad")}
PATHS = [*JOINT, "flat", "flat_empty", "tp"]
ONE_RANK_GRAD_REL = 1e-4


def _made_perm(t_len: int, e: int) -> np.ndarray:
    """A permutation of the T*E rows whose first half holds the arenas of
    rank 0 (e < E/2) and whose second half rank 1's, each shuffled."""
    rng = np.random.default_rng(7)
    rows = np.arange(t_len * e)
    first = rows[rows % e < e // 2]
    second = rows[rows % e >= e // 2]
    return np.concatenate([rng.permutation(first), rng.permutation(second)])


def _spec(cfg, policy_kw, op="train_op") -> np.ndarray:
    return np.asarray(json.dumps({"cfg": dataclasses.asdict(cfg), "policy": policy_kw, "op": op}))


def _job_inputs(name, cfg, policy_kw, ts, traj, last_obs, perms=None, op="train_op"):
    inp = {f"{name}/spec": _spec(cfg, policy_kw, op)}
    w.flatten(ts, f"{name}/ts", inp)
    w.flatten(traj, f"{name}/traj", inp)
    w.flatten(last_obs if isinstance(last_obs, dict) else {"x": last_obs}, f"{name}/last_obs",
              inp)
    if perms is not None:
        inp[f"{name}/perms"] = np.asarray(perms, np.int64)
    return inp


def _joint_case():
    """JAX's `train_op` on the joint path with the made second epoch, and
    the port's inputs for each joint path."""
    case = _make_case(DIMS)
    traj, last_obs = _trajectory()
    t_len, e = traj["done"].shape[:2]
    meta = case["meta"]
    packed = np.stack([np.asarray(pack_rollout_row(
        meta, {k: jnp.asarray(v[t]) for k, v in traj["obs"].items()},
        jnp.asarray(traj["action"][t]), jnp.asarray(traj["logp"][t]),
        jnp.asarray(traj["value"][t]))) for t in range(t_len)])
    batch = RolloutBatch(obs=None, action=jnp.asarray(traj["action"]),
                         logp=jnp.asarray(traj["logp"]), value=jnp.asarray(traj["value"]),
                         reward=jnp.asarray(traj["reward"]), done=jnp.asarray(traj["done"]),
                         last_obs={k: jnp.asarray(v) for k, v in last_obs.items()},
                         packed=jnp.asarray(packed))
    key = jax.random.PRNGKey(4)
    keys = jax.random.split(key, FLAGS["ppo_epochs"])
    perms = np.stack([np.asarray(jax.random.permutation(keys[0], t_len * e)),
                      _made_perm(t_len, e)])
    real = jax.random.permutation

    def made(k, n):  # the permutation of the epoch whose key `k` is
        return jnp.asarray(perms)[jnp.argmax(jnp.all(k == keys, axis=-1))]

    jax.random.permutation = made
    try:
        jpol = JPolicy(JCfg(use_tp_net=False, **FLAGS), n_agents=N_AG, action_dim=A,
                       obs_is_dict=True)
        jts2, jm = jpol.train_op(case["jts"], batch, key)
    finally:
        jax.random.permutation = real
    inputs = {}
    obs = {k: torch.as_tensor(v) for k, v in case["obs"].items()}
    for name, extra in JOINT.items():
        cfg = MAPPOCfg(use_tp_net=False, **FLAGS, **extra)
        tpol = MAPPOPolicy(cfg, n_agents=N_AG, action_dim=A, obs_is_dict=True, device="cpu")
        ts = bridge.policy_state(tpol, obs, jax.device_get(case["jts"].actor_params),
                                 jax.device_get(case["jts"].critic_params))
        inputs.update(_job_inputs(f"update:{name}", cfg,
                                  dict(n_agents=N_AG, action_dim=A, obs_is_dict=True), ts,
                                  traj, last_obs, perms))
    return inputs, (jts2, {k: float(v) for k, v in jm.items()})


def _flat_case():
    c1, perms, traj, upd = _jax_update("float32")
    _, _, tpol = _policies("float32")
    obs = np.array(c1.obs)
    ts = _flat_port_state(tpol, c1.ts, obs)
    kw = dict(n_agents=1, action_dim=4, obs_is_dict=False)
    t_len, e = traj["reward"].shape[:2]
    made = np.stack([perms[0], _made_perm(t_len, e)])
    inputs = {**_job_inputs("update:flat", tpol.cfg, kw, ts, traj, obs, perms),
              **_job_inputs("update:flat_empty", tpol.cfg, kw, ts, traj, obs, made)}
    return inputs, (*upd["float32"], torch.as_tensor(obs))


def _tp_case(pair, monkeypatch):
    jpol, jts, tpol, tts, obs = pair
    rng = np.random.default_rng(5)
    t_len, e = 12, 16
    traj = {"tp_input": rng.normal(size=(t_len, e, 10, 16)).astype(np.float32),
            "tp_gt": rng.uniform(-1, 1, (t_len, e, 3)).astype(np.float32),
            "done": rng.random((t_len, e, 1)) < 0.05,
            "tp_done": rng.random((t_len, e, 1)) < 0.9}
    batch = RolloutBatch(obs=None, action=None, logp=None, value=None, reward=None,
                         done=jnp.asarray(traj["done"]), last_obs=None,
                         tp_input=jnp.asarray(traj["tp_input"]),
                         tp_gt=jnp.asarray(traj["tp_gt"]), tp_done=jnp.asarray(traj["tp_done"]))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jtl, "_on_tpu", lambda: False)
    monkeypatch.setattr(jfe, "_on_tpu", lambda: False)
    rec = JPolicy(JCfg(use_tp_net=True), n_agents=tpol.n_agents, action_dim=4,
                  obs_is_dict=True, tp_input_dim=16)
    rec.tp_tx = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, u), u))
    _, jm = jpol._update_tp(jts, batch, jax.random.PRNGKey(0))
    grec, _ = rec._update_tp(jts.replace(tp_opt=rec.tp_tx.init(jts.tp_params)), batch,
                             jax.random.PRNGKey(0))
    want = bridge.tp_leaves(jax.device_get(grec.tp_opt))
    kw = dict(n_agents=tpol.n_agents, action_dim=4, obs_is_dict=True, tp_input_dim=16)
    inputs = _job_inputs("update:tp", tpol.cfg, kw, tts, traj, obs, op="update_tp")
    return inputs, (float(jm["TP_loss"]), want)


@pytest.fixture(scope="module")
def updates(pair, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        tp_inputs, tp_ref = _tp_case(pair, mp)
    finally:
        mp.undo()
    joint_inputs, joint_ref = _joint_case()
    flat_inputs, flat_ref = _flat_case()
    inputs = {**joint_inputs, **flat_inputs, **tp_inputs}
    jobs = [f"update:{p}" for p in PATHS]
    ranks = w.launch(2, jobs, inputs, tmp_path_factory.mktemp("parallel_update"))
    one = w.run_jobs(jobs, inputs)
    return dict(ranks=ranks, one=one, joint=joint_ref, flat=flat_ref, tp=tp_ref)


@pytest.mark.parametrize("path", PATHS)
def test_sharded_update_matches_jax_and_one_rank(updates, path):
    job = f"update:{path}"
    a, b = (r[job] for r in updates["ranks"])
    one = updates["one"][job]
    assert set(a) == set(b) == set(one)
    for k in a:  # the replicated learner: bit-identical ranks
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    first = [k for k in one if k.startswith("grad/0/")]
    assert first
    for k in first:
        scale = float(np.abs(one[k]).max())
        assert float(np.abs(a[k] - one[k]).max()) <= ONE_RANK_GRAD_REL * scale + 1e-12, k

    if path in JOINT:
        jts2, jm = updates["joint"]
        for k in INFO_KEYS:
            rel = NORM_REL if k.endswith("grad_norm") else METRIC_REL
            np.testing.assert_allclose(float(a[f"metrics/{k}"]), jm[k], rtol=rel, atol=1e-5,
                                       err_msg=k)
        ap, cp = jax.device_get(jts2.actor_params), jax.device_get(jts2.critic_params)
        for name, want in (("actor", bridge.encoder_leaves(ap)),
                           ("critic", bridge.encoder_leaves(cp))):
            got = torch.split(torch.as_tensor(a[f"ts/{name}/flat"]), [l.numel() for l in want])
            for i, (g, wl) in enumerate(zip(got, want)):
                atol = KEY_BIAS_ATOL if i == len(want) - 15 else PARAM_ATOL
                np.testing.assert_allclose(g.numpy(), wl.reshape(-1).numpy(), rtol=0, atol=atol,
                                           err_msg=f"{name} leaf {i}")
        np.testing.assert_allclose(a["ts/log_std"], bridge.actor_log_std(ap).numpy(), rtol=0,
                                   atol=PARAM_ATOL)
    elif path == "flat":
        jts, jm, obs = updates["flat"]
        _, _, tpol = _policies("float32")
        ts = w.unflatten(tpol.init(obs, torch.Generator().manual_seed(0)), a, "ts")
        tm = {k[len("metrics/"):]: torch.tensor(v) for k, v in a.items()
              if k.startswith("metrics/")}
        _hold_f32_update(ts, tm, jts, jm)
    elif path == "flat_empty":
        for k in one:
            if k.startswith("metrics/"):
                np.testing.assert_allclose(a[k], one[k], rtol=1e-4, atol=1e-7, err_msg=k)
            elif k.startswith("ts/") and "_opt/" not in k:
                assert float(np.abs(a[k] - one[k]).max()) <= 2e-6, k
    else:
        loss, want = updates["tp"]
        np.testing.assert_allclose(float(a["metrics/TP_loss"]), loss, rtol=1e-5)
        for j, wl in enumerate(want):
            g = a[f"grad/0/{j}"]
            assert g.shape == tuple(wl.shape)
            assert float(np.abs(g - wl.numpy()).max()) < GRAD_REL * float(wl.abs().max()) + 1e-7


def test_world_one_group_equals_no_group(tmp_path):
    """One rank with a gloo group (the collectives run) against no group:
    the same HideAndSeek iteration, bit for bit."""
    grouped = w.launch(1, ["iteration"], {}, tmp_path)[0]["iteration"]
    plain = w.run_jobs(["iteration"], {})["iteration"]
    assert set(grouped) == set(plain)
    for k in plain:
        np.testing.assert_array_equal(grouped[k], plain[k], err_msg=k)


# ------------------------------------------------------------- the shard
def test_shard_draws_are_the_global_draws_rows():
    gen = torch.Generator().manual_seed(1)
    whole = torch.rand((8, 3, 2), generator=gen)
    for r in range(4):
        shard = dist.EnvShard.of(8, r, 4)
        g = torch.Generator().manual_seed(1)
        part = shard.draw(lambda s: torch.rand(s, generator=g), (2, 3, 2))
        torch.testing.assert_close(part, whole[2 * r: 2 * r + 2], rtol=0, atol=0)
        assert torch.equal(g.get_state(), gen.get_state())
    g = torch.Generator().manual_seed(1)
    noise = dist.EnvShard.of(6, 1, 2).draw(lambda s: torch.randn(s, generator=g), (4, 3), axis=1)
    torch.testing.assert_close(noise, torch.randn((4, 6), generator=torch.Generator()
                                                  .manual_seed(1))[:, 3:], rtol=0, atol=0)


def test_collectives_are_the_identity_without_a_group():
    x = torch.arange(6.0).reshape(3, 2)
    assert not dist.is_initialized() and dist.world_size() == 1 and dist.rank() == 0
    for fn in (dist.all_reduce_sum, dist.all_reduce_max, dist.broadcast, dist.all_gather_envs):
        assert fn(x) is x
    assert dist.any_across(torch.tensor([False, True])) is True
    assert dist.local_env_slice(10) == slice(0, 10)
    assert dist.init_distributed() is False  # a single process: no group


@pytest.mark.parametrize("num_envs,world", [(15, 2), (10, 4), (3, 2)])
def test_arenas_not_divisible_by_the_world_size_are_refused(num_envs, world):
    with pytest.raises(ValueError, match="not divisible"):
        dist.EnvShard.of(num_envs, 0, world)


def test_loss_rows_refuse_a_normaliser_below_the_rows():
    s = 6
    x = torch.zeros((s, 8))
    rows = (torch.zeros((s, A)), torch.zeros((s, 1)), torch.zeros((s, 1)), torch.zeros((s, 1)),
            torch.zeros((s, 1)), torch.zeros(A))
    for n_rows in (s, 4 * s):  # the global count may exceed this rank's rows
        assert len(fe._loss_rows(fe.PPOLossCfg(0.1, 10.0, A, n_rows), x, *rows)) == 6
    with pytest.raises(ValueError, match="n_rows"):
        fe._loss_rows(fe.PPOLossCfg(0.1, 10.0, A, s - 1), x, *rows)


def test_shard_and_gather_carry_round_trip():
    """A one-rank HideAndSeek carry sliced into 2 shards holds each rank's
    arenas (the replicated fields whole); joining the shards' leaves gives
    the carry back."""
    from mupe_tpu_torch.envs import HideAndSeekEnvgen, HideAndSeekEnvgenCfg
    from mupe_tpu_torch.learning import init_carry

    env = HideAndSeekEnvgen(HideAndSeekEnvgenCfg(num_envs=4, buffer_length=6, use_tp_net=False),
                            device="cpu")
    pol = MAPPOPolicy(MAPPOCfg(), n_agents=3, action_dim=4, obs_is_dict=True, device="cpu")
    carry = init_carry(env, pol, torch.Generator().manual_seed(0))
    shards = [dist.shard_carry(carry, dist.EnvShard.of(4, r, 2)) for r in range(2)]
    assert dist.gather_carry(carry, dist.EnvShard.of(4, 0, 1)) is carry
    for s in shards:
        assert s.ts is carry.ts and s.generator is carry.generator
        assert s.env_state.gen is carry.env_state.gen and s.env_state.v_prey is carry.env_state.v_prey
        assert s.env_state.drone.pos.shape[0] == 2 and s.obs["state_self"].shape[0] == 2
    torch.testing.assert_close(torch.cat([s.env_state.cylinders for s in shards]),
                               carry.env_state.cylinders, rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([s.env_state.stats["success"] for s in shards]),
                               carry.env_state.stats["success"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="arenas"):
        dist.shard_carry(shards[0], dist.EnvShard.of(4, 0, 2))
