"""The in-kernel PPO loss update of the port against the JAX package.

The JAX side runs its Pallas kernels `_pair_fwd_loss_kernel` and
`_pair_fwd_loss_agrad_kernel` in interpret mode, as tests/test_fused_encoder.py
does, on S = 40 rows (20 samples of 2 agents) with `EncoderSpec(tile=32,
tile_fwd=32)`, so the kernels' last tile holds 24 padded rows that their row
mask must drop.  Inputs come from a numpy seed; the parameters are a flax
Actor / Critic's (heads at unit gain, a non-zero log_std, so every term of
the loss moves), converted by `bridge`.

Tolerances:
* per-row outputs (dmu, dv1, dv2, stats) of the plain versions against the
  kernels: `KERNEL_TOL` (5e-3 of the scale at most, 1e-4 of the mean
  magnitude on average): both sides round at `_forward_core`'s points and sum
  in another order; the stats' column sums within 1e-3 of the sum of
  their column's magnitudes (measured up to 1.4e-4, the clamped log-ratio);
* the actor's gradients of the agrad kernel, and the encoder gradients of the
  drivers: test_torch_encoder_bwd.py's per-leaf limits (`PARITY_TOL`);
* the update against the JAX package's (`_update_joint_direct`, `train_op`)
  and against the port's `_update_joint_flat`: the JAX package's own limits
  for its direct path (tests/test_fused_encoder.py): metrics within 5e-3 and
  gradient norms within 2e-3 of max(1, |reference|), parameters within
  2.5e-3 absolute (Adam's first step moves a parameter by about ±lr = 5e-4
  whatever its gradient's size).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mupe_tpu.ops.fused_encoder as jfe
from mupe_tpu.learning.mappo import MAPPOCfg as JCfg
from mupe_tpu.learning.mappo import MAPPOPolicy as JPolicy
from mupe_tpu.learning.mappo import RolloutBatch, pack_rollout_row
from mupe_tpu.learning.mappo import compute_pack_meta as jmeta
from mupe_tpu_torch import bridge
from mupe_tpu_torch.learning import MAPPOCfg, MAPPOPolicy
from mupe_tpu_torch.ops import fused_encoder as fe
from mupe_tpu_torch.ops.tolerance import GradTol, in_f64

torch.set_num_threads(1)
N, N_AG, A = 20, 2, 4
S = N * N_AG
TILE = 32
MODES = ["fwdloss", "agrad"]
PARITY_TOL = GradTol(max_rel=1e-2, mean_rel=2e-3, noise_floor=1e-5, noise_leaves=(-15,))
SUM_REL = 1e-3
METRIC_TOL, NORM_TOL, PARAM_ATOL = 5e-3, 2e-3, 2.5e-3
INFO_KEYS = ("policy_loss", "actor_grad_norm", "entropy", "ESS", "value_loss",
             "critic_grad_norm", "explained_var", "approx_kl")


# (tokens, features) of each observation group: the main path's, and an 8-token
# observation with state_self 50 wide (4 pursuers, 4 cylinder tokens, 10
# predicted steps)
DIMS = {"state_self": (1, 35), "cylinders": (3, 5), "state_others": (2, 3)}
WIDE_DIMS = {"state_self": (1, 50), "cylinders": (4, 5), "state_others": (3, 3)}
# and 16 tokens over 148 columns (6 pursuers, 10 cylinder tokens, 21 predicted steps)
TOK16_DIMS = {"state_self": (1, 83), "cylinders": (10, 5), "state_others": (5, 3)}


def _obs(rng, lead, dims=DIMS):
    return {k: rng.normal(size=lead + (N_AG,) + kd).astype(np.float32) for k, kd in dims.items()}


def _jpolicy(**extra):
    return JPolicy(JCfg(use_tp_net=False, **extra), n_agents=N_AG, action_dim=A,
                   obs_is_dict=True)


def _tpolicy(**extra):
    return MAPPOPolicy(MAPPOCfg(use_tp_net=False, **extra), n_agents=N_AG, action_dim=A,
                       obs_is_dict=True, device="cpu")


def _make_case(dims):
    rng = np.random.default_rng(0)
    jpol = _jpolicy()
    obs = _obs(rng, (N,), dims)
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    jts = jpol.init(jax.random.PRNGKey(0), jobs)
    ap = jts.actor_params
    ap["params"]["DiagGaussianHead_0"]["Dense_0"]["kernel"] *= 100.0
    ap["params"]["DiagGaussianHead_0"]["log_std"] = jnp.asarray([0.1, -0.2, 0.3, -0.4])
    jts.critic_params["params"]["Dense_0"]["kernel"] *= 100.0
    jts = jts.replace(actor_opt=jpol.actor_tx.init(ap),
                      critic_opt=jpol.critic_tx.init(jts.critic_params))
    meta = jmeta(jobs, N_AG, A)
    x = np.concatenate([obs[n].reshape(N, N_AG, -1) for n in meta.names], -1).reshape(S, -1)
    mb = {"obs_rows": x, "action": (0.5 * rng.normal(size=(S, A))).astype(np.float32),
          "logp": rng.normal(-5.5, 0.2, (S,)).astype(np.float32),
          "value": rng.normal(0.0, 0.3, (S,)).astype(np.float32),
          "advantages": rng.normal(0.0, 1.0, (S,)).astype(np.float32),
          "returns": rng.normal(0.0, 0.3, (S,)).astype(np.float32)}
    mb["returns"][::10] += 15.0  # the Huber loss's linear branch (delta 10)
    groups = meta.groups
    ja = jfe.EncoderSpec(groups=groups, head_dim=A, tile=TILE, tile_fwd=TILE)
    jc = jfe.EncoderSpec(groups=groups, head_dim=1, tile=TILE, tile_fwd=TILE)
    return dict(jpol=jpol, jts=jts, obs=obs, meta=meta, mb=mb, ja=ja, jc=jc,
                la=jfe.extract_leaves(ja, jts.actor_params, list(meta.names)),
                lc=jfe.extract_leaves(jc, jts.critic_params, list(meta.names)),
                ta=fe.EncoderSpec(groups=groups, head_dim=A),
                tc=fe.EncoderSpec(groups=groups, head_dim=1),
                tla=list(bridge.encoder_leaves(jax.device_get(jts.actor_params))),
                tlc=list(bridge.encoder_leaves(jax.device_get(jts.critic_params))),
                log_std=bridge.actor_log_std(jax.device_get(jts.actor_params)))


@pytest.fixture(scope="module")
def case():
    return _make_case(DIMS)


@pytest.fixture(scope="module")
def wide_case():
    return _make_case(WIDE_DIMS)


@pytest.fixture(scope="module")
def tok16_case():
    return _make_case(TOK16_DIMS)


def _saturate(mb):
    """A third of the rows with the log-ratio past the +-20 clamp, each way."""
    logp = mb["logp"].copy()
    logp[:7] += 40.0
    logp[-7:] -= 40.0
    return dict(mb, logp=logp)


def _loss_cfgs(c):
    cfg = JCfg()
    return (jfe.PPOLossCfg(cfg.clip_param, cfg.huber_delta, A, S),
            fe.PPOLossCfg(cfg.clip_param, cfg.huber_delta, A, S))


def _row_inputs(mb):
    """(x, act, logp_old, adv, v_old, ret) as [S, ...] numpy arrays."""
    return (mb["obs_rows"], mb["action"], mb["logp"][:, None], mb["advantages"][:, None],
            mb["value"][:, None], mb["returns"][:, None])


def _jax_rows(mb):
    rows = -(-S // TILE) * TILE
    return [jnp.concatenate([jnp.asarray(a), jnp.zeros((rows - S,) + a.shape[1:])], 0)
            for a in _row_inputs(mb)]


def _torch_rows(mb):
    return [torch.as_tensor(a) for a in _row_inputs(mb)]


def _close_rows(got, want):
    errs = fe.KERNEL_TOL.errors(got, torch.as_tensor(np.array(want)))
    assert fe.KERNEL_TOL.holds(errs), errs


def _close_sums(got, want, rows):
    """Stats column sums, each within SUM_REL of the sum of its column's
    magnitudes over `rows` (the per-row stats)."""
    err = (got - torch.as_tensor(np.array(want))).abs() / (rows.abs().sum(0) + 1e-6)
    assert float(err.max()) <= SUM_REL, err


def _close_grads(got, want, exact=None):
    """With `exact` (the port's plain version `got` in f64), each mean limit,
    and the noise leaves' max limit, is at least FLOOR_MULT times the error of
    `got` against it."""
    want = [torch.as_tensor(np.array(w)).reshape(tuple(g.shape)) for w, g in zip(want, got)]
    if exact is None:
        errs = PARITY_TOL.errors([g.float() for g in got], want)
        assert PARITY_TOL.holds(errs), [(i, errs[i]) for i in PARITY_TOL.failing(errs)]
        return
    got = [g.float() for g in got]
    scale = max(g.abs().max().item() for g in got)
    noise = max((got[i] - exact[i]).abs().max().item() / scale for i in PARITY_TOL.noise_leaves)
    tol = dataclasses.replace(PARITY_TOL, floor_mult=fe.FLOOR_MULT,
                              noise_floor=max(PARITY_TOL.noise_floor, fe.FLOOR_MULT * noise))
    errs = tol.errors(want, got, exact)
    assert tol.holds(errs), [(i, errs[i]) for i in tol.failing(errs)]


@pytest.mark.parametrize("saturated", [False, True])
def test_reference_pair_fwd_loss_matches_jax_kernel(case, saturated):
    mb = _saturate(case["mb"]) if saturated else case["mb"]
    jloss, tloss = _loss_cfgs(case)
    x, *rows = _jax_rows(mb)
    call = jfe._build_pair_loss_call(case["ja"], case["jc"], jloss, x.shape[0], True)
    jdmu, jdv1, jdv2, jstats = call(x, *rows, jnp.asarray(case["log_std"].numpy()),
                                    tuple(case["la"]), tuple(case["lc"]))
    tx, *trows = _torch_rows(mb)
    dmu, dv1, dv2, stats = fe.reference_pair_fwd_loss(
        case["ta"], case["tc"], tloss, case["tla"], case["tlc"], case["log_std"], tx, *trows)
    for got, want in ((dmu, jdmu), (dv1, jdv1), (dv2, jdv2), (stats, jstats)):
        _close_rows(got, np.asarray(want)[:S])
    _close_sums(stats.sum(0), np.asarray(jstats).sum(0), stats)
    if saturated:  # zero gradient on the saturated rows
        assert float(dmu[:7].abs().max()) == 0.0 and float(dmu[-7:].abs().max()) == 0.0
        assert float(dmu[7:-7].abs().max()) > 0.0


def test_reference_pair_fwd_loss_agrad_matches_jax_kernel(case):
    jloss, tloss = _loss_cfgs(case)
    x, *rows = _jax_rows(case["mb"])
    call = jfe._build_pair_loss_agrad_call(case["ja"], case["jc"], jloss, x.shape[0], True)
    jdv1, jdv2, jstats, jga = call(x, *rows, jnp.asarray(case["log_std"].numpy()),
                                   tuple(case["la"]), tuple(case["lc"]))
    tx, *trows = _torch_rows(case["mb"])
    dv1, dv2, stats, ga = fe.reference_pair_fwd_loss_agrad(
        case["ta"], case["tc"], tloss, case["tla"], case["tlc"], case["log_std"], tx, *trows)
    for got, want in ((dv1, jdv1), (dv2, jdv2), (stats, jstats)):
        _close_rows(got, np.asarray(want)[:S])
    _close_sums(stats.sum(0), np.asarray(jstats).sum(0), stats)
    _close_grads(ga, jga)


@pytest.mark.parametrize("mode", MODES + ["agrad_8_tokens_wide", "agrad_16_tokens"])
def test_drivers_match_jax(request, mode):
    """Both drivers on the main path's observation; the agrad driver also on
    8 tokens with a 50-wide group (the kernels' 8-row tile on the card) and
    on 16 tokens over 148 columns (their 16-token instance).  There, at 40
    rows and the heads at 100x gain, one row's bf16 flip cascade in the f32
    plain version moves its ratio and every gradient's mean by ~3e-3: the
    16-token case is held with limits of at least FLOOR_MULT times the f32
    plain version's error against itself in f64 (tolerance.py)."""
    case = request.getfixturevalue({"wide": "wide_case", "tokens": "tok16_case"}.get(
        mode.split("_")[-1], "case"))
    jloss, tloss = _loss_cfgs(case)
    jfn, tfn = {"fwdloss": (jfe.fused_pair_ppo_grads_fwdloss, fe.pair_ppo_grads_fwdloss),
                "agrad": (jfe.fused_pair_ppo_grads, fe.pair_ppo_grads)}[mode.split("_")[0]]
    x, *rows = _row_inputs(case["mb"])
    jdla, jdls, jdlc, jsums = jfn(case["ja"], case["jc"], jloss, case["la"], case["lc"],
                                  jnp.asarray(case["log_std"].numpy()), jnp.asarray(x),
                                  *map(jnp.asarray, rows), interpret=True)
    targs = (case["ta"], case["tc"], tloss, case["tla"], case["tlc"], case["log_std"],
             *_torch_rows(case["mb"]))
    dla, dls, dlc, sums = tfn(*targs)
    exact = in_f64(tfn, *targs) if mode.endswith("tokens") else (None, None, None)
    _close_grads(dla, jdla, exact[0])
    _close_grads(dlc, jdlc, exact[2])
    stats = fe.reference_pair_fwd_loss(case["ta"], case["tc"], tloss, case["tla"], case["tlc"],
                                       case["log_std"], *_torch_rows(case["mb"]))[3]
    _close_sums(sums, jsums, stats)
    if exact[1] is None:
        np.testing.assert_allclose(dls.numpy(), np.asarray(jdls), rtol=1e-4, atol=1e-6)
    else:  # at least FLOOR_MULT times the f32 plain version's error against f64
        floor = (dls - exact[1]).abs().numpy()
        assert (np.abs(dls.numpy() - np.asarray(jdls))
                <= np.maximum(1e-4 * np.abs(np.asarray(jdls)) + 1e-6, fe.FLOOR_MULT * floor)).all()


def _port_state(case, **extra):
    tpol = _tpolicy(use_inkernel_loss=True, **extra)
    jts = case["jts"]
    ts = bridge.policy_state(tpol, {k: torch.as_tensor(v) for k, v in case["obs"].items()},
                             jax.device_get(jts.actor_params), jax.device_get(jts.critic_params))
    return tpol, ts


def _close_info(got, want):
    for k in INFO_KEYS:
        tol = NORM_TOL if k.endswith("grad_norm") else METRIC_TOL
        g, w = float(got[k]), float(want[k])
        assert abs(g - w) <= tol * max(1.0, abs(w)), (k, g, w)


def _close_params(ts, want_a, want_ls, want_c):
    pairs = ((ts.actor.flat, want_a), (ts.log_std, want_ls), (ts.critic.flat, want_c))
    for got, want in pairs:
        assert float((got.detach() - want).abs().max()) < PARAM_ATOL


def _jax_params(jts):
    a, c = jax.device_get(jts.actor_params), jax.device_get(jts.critic_params)
    return (torch.cat([l.reshape(-1) for l in bridge.encoder_leaves(a)]), bridge.actor_log_std(a),
            torch.cat([l.reshape(-1) for l in bridge.encoder_leaves(c)]))


@pytest.mark.parametrize("mode", MODES)
def test_update_joint_direct_matches_jax(case, mode, monkeypatch):
    if mode == "agrad":  # the JAX package reads its launch mode from the environment
        monkeypatch.setenv("MUPE_DIRECT_MODE", "agrad")
    jmb = {k: jnp.asarray(v) for k, v in case["mb"].items()}
    jts2, jinfo = case["jpol"]._update_joint_direct(case["jts"], jmb, interpret=True,
                                                    pack_meta=case["meta"])
    tpol, ts = _port_state(case, direct_mode=mode)
    tinfo = tpol._update_joint_direct(ts, {k: torch.as_tensor(v) for k, v in case["mb"].items()})
    assert set(tinfo) == set(jinfo)
    _close_info(tinfo, jinfo)
    _close_params(ts, *_jax_params(jts2))


@pytest.mark.parametrize("saturated", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_update_joint_direct_matches_update_joint_flat(case, mode, saturated):
    """The port's two updates on one minibatch: the same step (the pattern of
    tests/test_fused_encoder.py's direct-path tests, saturated rows too)."""
    mb = {k: torch.as_tensor(v) for k, v in
          (_saturate(case["mb"]) if saturated else case["mb"]).items()}
    tpol, ts_direct = _port_state(case, direct_mode=mode)
    _, ts_flat = _port_state(case)
    info_d = tpol._update_joint_direct(ts_direct, mb)
    info_f = tpol._update_joint_flat(ts_flat, mb)
    _close_info(info_d, info_f)
    _close_params(ts_direct, ts_flat.actor.flat.detach(), ts_flat.log_std, ts_flat.critic.flat.detach())


def _trajectory(seed=3, t_len=4, e=10):
    rng = np.random.default_rng(seed)
    obs = {k: v.reshape((t_len, e) + v.shape[1:]) for k, v in _obs(rng, (t_len * e,)).items()}
    last_obs = _obs(rng, (e,))
    traj = {"obs": obs,
            "action": (0.5 * rng.normal(size=(t_len, e, N_AG, A))).astype(np.float32),
            "logp": rng.normal(-5.5, 0.2, (t_len, e, N_AG, 1)).astype(np.float32),
            "value": rng.normal(0.0, 0.3, (t_len, e, N_AG, 1)).astype(np.float32),
            "reward": rng.normal(0.0, 0.5, (t_len, e, N_AG, 1)).astype(np.float32),
            "done": rng.random((t_len, e, 1)) < 0.1}
    return traj, last_obs


@pytest.mark.parametrize("mode", MODES)
def test_train_op_with_inkernel_loss_and_target_kl_matches_jax(case, mode, monkeypatch):
    """One `train_op` (2 epochs x 2 minibatches of 20 samples, target_kl
    below the KL's floor: the update stops after the first minibatch) on the
    same trajectory with the permutations JAX draws from its key.  The JAX
    direct path is forced into interpret mode (it launches the TPU kernels
    otherwise)."""
    if mode == "agrad":
        monkeypatch.setenv("MUPE_DIRECT_MODE", "agrad")
    for name in ("fused_pair_ppo_grads_fwdloss", "fused_pair_ppo_grads"):
        fn = getattr(jfe, name)
        monkeypatch.setattr(jfe, name, lambda *a, _fn=fn, interpret=False, **k:
                            _fn(*a, interpret=True, **k))
    flags = dict(train_every=4, num_minibatches=2, ppo_epochs=2, target_kl=-1.0)
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
    jpol = _jpolicy(use_inkernel_loss=True, **flags)
    key = jax.random.PRNGKey(4)
    jts2, jm = jpol.train_op(case["jts"], batch, key)
    perms = np.stack([np.asarray(jax.random.permutation(k, t_len * e))
                      for k in jax.random.split(key, flags["ppo_epochs"])])
    tpol, ts = _port_state(case, direct_mode=mode, **flags)
    tt = {k: ({n: torch.as_tensor(a) for n, a in v.items()} if isinstance(v, dict)
              else torch.as_tensor(v)) for k, v in traj.items()}
    ts, tm = tpol.train_op(ts, tt, {k: torch.as_tensor(v) for k, v in last_obs.items()},
                           perms=torch.as_tensor(perms))
    assert set(tm) == set(jm)
    _close_info(tm, jm)
    for k in ("advantages_mean", "advantages_std", "action_norm", "value_running_mean"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(tm["kl_stop"]) == float(jm["kl_stop"]) == 1.0
    assert int(ts.actor_opt.count) == 1  # held from the second minibatch on, Adam state too
    _close_params(ts, *_jax_params(jts2))


def test_head_bias_gradient_is_the_column_sum_of_dmu(case):
    """Row coverage on the CPU: the agrad path's actor head-bias gradient is
    the sum of the fwdloss path's dmu over every row."""
    _, tloss = _loss_cfgs(case)
    args = (case["ta"], case["tc"], tloss, case["tla"], case["tlc"], case["log_std"],
            *_torch_rows(case["mb"]))
    dmu = fe.pair_forward_loss(*args)[0]
    dla = fe.pair_forward_loss_agrad(*args)[3]
    torch.testing.assert_close(dla[-1], dmu.sum(0), rtol=0, atol=0)


def test_direct_mode_is_checked():
    with pytest.raises(ValueError, match="direct_mode"):
        _tpolicy(use_inkernel_loss=True, direct_mode="fused")
