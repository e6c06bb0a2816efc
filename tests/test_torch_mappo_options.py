"""MAPPO's options in the PyTorch port against the JAX package on the CPU:
per-agent actors (`share_actor=False`, on dict and on flat observations),
the relation encoders, and the centralized critic (`critic_input="state"`,
over a well-formed state dict); one `act` (JAX's action noise injected) and
one whole `train_op` (JAX's permutations, recomputed from its key) from the
same parameters, converted by `bridge.policy_state` (JAX's per-agent actors
are one stacked tree, split by the bridge, never re-drawn).  And the
reference's fault that the port keeps: the centralized critic cannot be
built over HideAndSeek's critic state, in the JAX package (its
`init_carry` fails) and in the port (a ValueError at `init`).

Tolerances.  float32 (the flat and relation-encoder cases): the forward
within 1e-5 of its scale; after a `train_op` (2 Adam steps) the metrics
within 1e-4 relative (+1e-7) and the parameters within 1e-5 of their scale,
all but a 1e-4 share of them: Adam's first step moves a parameter by about
±lr whatever its gradient's size, so a gradient within rounding of zero
takes either sign on either side (measured: 2 of 139,844), and those are
held to the 2 lr x steps such a flip can part them.  The encoder networks
(`PartialAttentionEncoder`): the port runs the kernel's plain version (bf16
operands, float32 sums and LayerNorms), the JAX package flax in
`compute_dtype` where its fused path is off (per-agent actors, the critic
beside them, the state critic), which rounds every Dense output to bf16 as
well: two bf16 schemes with different rounding points.  So each is held to
the floor, JAX's own bf16-vs-f32 difference on the same inputs, with JAX's
float32 result as the reference: the port's bf16 within 2x the floor of it
(max and mean per network, + 1e-6 of the scale; the actions, values and
log-probabilities of `act`, the parameters and metrics after `train_op`;
a metric + 1e-5 absolute, float32's rounding of an O(1) mean that cancels
to a small value, as explained_var does).  The ratio's metrics are read at
the batch's own policy (ratio 1 up to rounding), so they are the
log-probabilities' rounding noise: with d the largest difference between
the port's and JAX's float32 log-probabilities of the batch's actions, on
the update's own rows, policy_loss within A x d (advantages of unit
spread), ESS within 2 d and approx_kl within d^2.
The shared actor's update beside the state critic runs JAX's fused path,
whose CPU fallback is `reference_apply`, the port's plain version: held as
tests/test_torch_train_iter.py holds that path (parameters within 3e-3,
metrics within 2e-3 relative, gradient norms 1e-2).  The kernel rounds its
head's operands to bf16, as JAX's Pallas kernel does, where flax keeps the
head in float32; so these cases keep flax's initial head (gain 0.01), at
which that rounding is below the floor (at unit gain it is 100x larger and
would be measured instead: the port's float32 plain version then still
agrees with JAX's float32 update to 5e-6 per leaf).  Each agent's mean is
also held to JAX's `reference_apply` on that agent's rows and parameters
(the kernel's math) within 1e-5 of its scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.envs.hideandseek import HideAndSeek as JHideAndSeek
from mupe_tpu.envs.hideandseek import HideAndSeekCfg as JEnvCfg
from mupe_tpu.learning.mappo import MAPPOCfg as JCfg
from mupe_tpu.learning.mappo import MAPPOPolicy as JPolicy
from mupe_tpu.learning.mappo import RolloutBatch
from mupe_tpu.learning.rollout import init_carry as jinit_carry
import mupe_tpu.ops.fused_encoder as jfe
from mupe_tpu_torch import bridge
from mupe_tpu_torch.envs import HideAndSeek, HideAndSeekCfg
from mupe_tpu_torch.learning import MAPPOCfg, MAPPOPolicy, init_carry
from mupe_tpu_torch.learning.mappo import AgentStack, net_flats

torch.set_num_threads(1)
T, E, N, A = 4, 4, 3, 4
BASE = dict(train_every=T, num_minibatches=2, ppo_epochs=1, hidden_units=(32, 32))
F32_REL, METRIC_REL, FLOOR_MULT = 1e-5, 1e-4, 2.0
FLIP_SHARE, LR, METRIC_ABS = 1e-4, 5e-4, 1e-5
FUSED_PARAM_ATOL, FUSED_METRIC_REL = 3e-3, 2e-3


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


def _dict_obs(rng, lead):
    return {"state_self": rng.normal(size=lead + (N, 1, 11)).astype(np.float32),
            "cylinders": rng.normal(size=lead + (N, 3, 5)).astype(np.float32),
            "state_others": rng.normal(size=lead + (N, 2, 3)).astype(np.float32)}


def _state(rng, lead):
    """A well-formed critic state of HideAndSeek's field names: per-drone
    rows and the arena's cylinders, one rank."""
    return {"state_drones": rng.normal(size=lead + (N, 17)).astype(np.float32),
            "cylinders": rng.normal(size=lead + (3, 5)).astype(np.float32)}


def _flat_obs(rng, lead):
    return rng.normal(size=lead + (N, 20)).astype(np.float32)


def _heads_up(tree, gain):
    """Heads scaled by `gain` and a non-zero log_std, so every term moves."""
    p = dict(tree["params"])
    for k in p:
        if k == "DiagGaussianHead_0":
            p[k] = dict(p[k], Dense_0=dict(p[k]["Dense_0"], kernel=p[k]["Dense_0"]["kernel"] * gain),
                        log_std=p[k]["log_std"] + jnp.asarray([0.1, -0.2, 0.3, -0.4]))
        elif k == "Dense_0":
            p[k] = dict(p[k], kernel=p[k]["kernel"] * gain)
    return {"params": p}


def _setup(cfg_kw, obs_kind, dtype, gain=100.0):
    """JAX's policy and state, a batch from the float32 JAX policy's sampled
    actions (one trajectory for every dtype), and the port's policy and
    converted state."""
    rng = np.random.default_rng(0)
    make_obs = {"dict": _dict_obs, "flat": _flat_obs}[obs_kind]
    by_state = cfg_kw.get("critic_input") == "state"
    cfg = dict(BASE, compute_dtype=dtype, **cfg_kw)
    jpol = JPolicy(JCfg(**cfg), N, A, obs_is_dict=obs_kind == "dict")
    obs, last_obs = make_obs(rng, (T, E)), make_obs(rng, (E,))
    state = _state(rng, (T, E)) if by_state else None
    last_state = _state(rng, (E,)) if by_state else None
    jts = jax.jit(lambda k, o, s: jpol.init(k, o, state_example=s))(
        jax.random.PRNGKey(1), last_obs, last_state)
    ap, cp = _heads_up(jts.actor_params, gain), _heads_up(jts.critic_params, gain)
    jts = jts.replace(actor_params=ap, critic_params=cp, actor_opt=jpol.actor_tx.init(ap),
                      critic_opt=jpol.critic_tx.init(cp))
    pol32 = JPolicy(JCfg(**dict(cfg, compute_dtype="float32")), N, A,
                    obs_is_dict=obs_kind == "dict")
    act = jax.jit(lambda ts, o, k, s: pol32.act(ts, o, k, state=s))
    action, logp, value = act(jts, obs, jax.random.PRNGKey(2), state)
    batch = RolloutBatch(obs=obs, action=action, logp=logp, value=value,
                         reward=jnp.asarray(rng.normal(size=(T, E, N, 1)).astype(np.float32)),
                         done=jnp.asarray(rng.uniform(size=(T, E, 1)) < 0.2),
                         last_obs=last_obs, state=state, last_state=last_state)
    tpol = MAPPOPolicy(MAPPOCfg(**cfg), N, A, obs_is_dict=obs_kind == "dict", device="cpu")
    ts = bridge.policy_state(tpol, _t(last_obs), jax.device_get(ap), jax.device_get(cp),
                             state_example=None if state is None else _t(last_state))
    return jpol, jts, batch, tpol, ts


def _act(jpol, jts, batch, tpol, ts):
    """JAX's and the port's (action, logp, value) from the same noise."""
    key = jax.random.PRNGKey(5)
    first = lambda tree: jax.tree_util.tree_map(lambda x: x[0], tree)
    obs, state = first(batch.obs), None if batch.state is None else first(batch.state)
    jout = jax.jit(lambda ts_, o, s: jpol.act(ts_, o, key, state=s))(jts, obs, state)
    noise = torch.as_tensor(np.array(jax.random.normal(key, jout[0].shape)))
    tout = tpol.act(ts, _t(obs), noise=noise, state=None if state is None else _t(state))
    return [np.asarray(j, np.float32) for j in jout], [_np(t) for t in tout]


def _train(jpol, jts, batch, tpol, ts):
    key = jax.random.PRNGKey(7)
    new_jts, jm = jax.jit(jpol.train_op)(jts, batch, key)
    b = T * E
    perms = np.stack([np.asarray(jax.random.permutation(k, b))
                      for k in jax.random.split(key, jpol.cfg.ppo_epochs)])
    traj = {"obs": _t(batch.obs), "action": _t(batch.action), "logp": _t(batch.logp),
            "value": _t(batch.value), "reward": _t(batch.reward), "done": _t(batch.done)}
    if batch.state is not None:
        traj["state"] = _t(batch.state)
    new_ts, tm = tpol.train_op(ts, traj, _t(batch.last_obs), perms=torch.as_tensor(perms),
                               last_state=None if batch.last_state is None
                               else _t(batch.last_state))
    return jax.device_get(new_jts), {k: float(v) for k, v in jm.items()}, new_ts, \
        {k: float(v) for k, v in tm.items()}


def _flat(net, params):
    """A port network's (or stack's) parameters as one vector, and the JAX
    tree's in the same order."""
    if isinstance(net, AgentStack):
        want = [torch.cat([l.reshape(-1) for l in bridge.leaves_of(n, params, i)])
                for i, n in enumerate(net.nets)]
    else:
        want = [torch.cat([l.reshape(-1) for l in bridge.leaves_of(net, params)])]
    return _np(torch.cat([f.detach() for f in net_flats(net)])), _np(torch.cat(want))


def _log_std(jts):
    return np.asarray(jts.actor_params["params"]["DiagGaussianHead_0"]["log_std"])


def _hold_f32(cfg_kw, obs_kind):
    jpol, jts, batch, tpol, ts = _setup(cfg_kw, obs_kind, "float32")
    jact, tact = _act(jpol, jts, batch, tpol, ts)
    for j, t in zip(jact, tact):
        np.testing.assert_allclose(t, j, rtol=0, atol=F32_REL * np.abs(j).max())
    new_jts, jm, new_ts, tm = _train(jpol, jts, batch, tpol, ts)
    assert set(tm) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k], v, rtol=METRIC_REL, atol=1e-7, err_msg=k)
    steps = BASE["num_minibatches"] * BASE["ppo_epochs"]
    for name in ("actor", "critic"):
        got, want = _flat(getattr(new_ts, name), getattr(new_jts, f"{name}_params"))
        err = np.abs(got - want)
        assert np.mean(err > F32_REL * np.abs(want).max()) <= FLIP_SHARE, name
        assert err.max() <= 2 * LR * steps, (name, err.max())
    np.testing.assert_allclose(_np(new_ts.log_std), _log_std(new_jts), rtol=0, atol=F32_REL)
    return new_ts


def test_per_agent_actors_on_flat_observations_match_jax():
    ts = _hold_f32(dict(share_actor=False), "flat")
    assert isinstance(ts.actor, AgentStack) and len(ts.actor.nets) == N
    assert tuple(ts.log_std.shape) == (N, A)
    # one optimizer group: the clip's global norm runs over every agent's
    # parameters and log_std at once (optax.flatten over the stacked tree)
    assert len(ts.actor_params()) == N + 1 and len(ts.actor_opt.mu) == N + 1


@pytest.mark.parametrize("encoder", ["RelationEncoder", "PartialRelationEncoder"])
def test_relation_encoders_match_jax(encoder):
    _hold_f32(dict(attn_encoder=encoder), "dict")


def _logp_err(jpol, jts, batch, tpol, ts):
    """The largest |port - JAX| log-probability of the batch's actions over
    every row of the batch (the update's rows)."""
    jlp = jax.jit(lambda ts_, o, s: jpol._actor_dist(ts_.actor_params, o).log_prob(
        batch.action))(jts, batch.obs, batch.state)
    mean = tpol.act(ts, _t(batch.obs), deterministic=True,
                    state=None if batch.state is None else _t(batch.state))[0]
    from mupe_tpu_torch.learning.modules.distributions import Gaussian

    tlp = Gaussian(mean, ts.log_std.expand(mean.shape)).log_prob(_t(batch.action))
    return float(np.abs(_np(tlp) - np.asarray(jlp)).max())


def _floor_run(cfg_kw):
    """The port's bf16 `act` and `train_op` and JAX's in bf16 and f32.  The
    update is one minibatch: a second one would read its metrics after an
    Adam step, which turns a gradient's rounding into a whole ±lr a
    parameter, so the metrics are the shared initial parameters' here."""
    cfg_kw = dict(cfg_kw, num_minibatches=1)
    out = {}
    for dt in ("bfloat16", "float32"):
        jpol, jts, batch, tpol, ts = _setup(cfg_kw, "dict", dt, gain=1.0)
        jact, tact = _act(jpol, jts, batch, tpol, ts)
        lp_err = _logp_err(jpol, jts, batch, tpol, ts)
        out[dt] = (jact, tact) + _train(jpol, jts, batch, tpol, ts) + (lp_err,)
    return out


def _within_floor(got, want, want32, what):
    """The port's bf16 `got` within 2x the floor |want32 - want| of JAX's
    float32 result `want32`; returns that bound on the largest error."""
    err, floor = np.abs(got - want32), np.abs(want32 - want)
    slack = 1e-6 * np.abs(want).max()
    assert err.max() <= FLOOR_MULT * floor.max() + slack, (what, err.max(), floor.max())
    assert err.mean() <= FLOOR_MULT * floor.mean() + slack, (what, err.mean(), floor.mean())
    return FLOOR_MULT * floor.max() + slack


RATIO_METRICS = ("policy_loss", "ESS", "approx_kl")


def _hold_metrics(tm, jm, jm32, lp_err, keys):
    """`keys` against the floor; the ratio's metrics against the log-prob
    error `lp_err`."""
    bound = {"policy_loss": A * lp_err, "ESS": 2 * lp_err, "approx_kl": lp_err ** 2}
    for k in keys:
        limit = bound[k] if k in bound else FLOOR_MULT * abs(jm32[k] - jm[k])
        assert abs(tm[k] - jm32[k]) <= limit + METRIC_ABS, (k, tm[k], jm32[k], limit)


def test_per_agent_actors_on_dict_observations_match_jax():
    """Every network an `EncoderHead` (the kernels on the card; their plain
    version here); JAX runs them in flax, in `compute_dtype`."""
    jpol, jts, batch, tpol, ts = _setup(dict(share_actor=False), "dict", "bfloat16")
    obs = jax.tree_util.tree_map(lambda x: x[0], batch.obs)
    tmean = _np(tpol.act(ts, _t(obs), deterministic=True)[0])
    for i, net in enumerate(ts.actor.nets):
        leaves = [jnp.asarray(_np(l)) for l in net.leaves]
        x = jnp.concatenate([obs[k][:, i].reshape(E, -1) for k in ("state_self", "cylinders",
                                                                    "state_others")], axis=-1)
        want = np.asarray(jfe.reference_apply(jfe.EncoderSpec(groups=net.spec.groups, head_dim=A),
                                              leaves, x))
        np.testing.assert_allclose(tmean[:, i], want, rtol=0, atol=F32_REL * np.abs(want).max())
    out = _floor_run(dict(share_actor=False))
    jact, tact, new_jts, jm, new_ts, tm, _ = out["bfloat16"]
    jact32, _, new_jts32, jm32, _, _, lp_err = out["float32"]
    for i, what in enumerate(("action", "logp", "value")):
        _within_floor(tact[i], jact[i], jact32[i], what)
    for name in ("actor", "critic"):
        got, want = _flat(getattr(new_ts, name), getattr(new_jts, f"{name}_params"))
        _, want32 = _flat(getattr(new_ts, name), getattr(new_jts32, f"{name}_params"))
        _within_floor(got, want, want32, name)
    _hold_metrics(tm, jm, jm32, lp_err, jm)


def test_state_critic_matches_jax():
    """`critic_input="state"`: a critic of n outputs over the state dict
    (the query token is `state_drones`' first), trained from the
    minibatches' gathered states; the shared actor takes JAX's fused path."""
    out = _floor_run(dict(critic_input="state"))
    jact, tact, new_jts, jm, new_ts, tm, _ = out["bfloat16"]
    jact32, _, new_jts32, jm32, _, _, lp_err = out["float32"]
    assert new_ts.critic.spec.head_dim == N and new_ts.critic.spec.groups == ((N, 17), (3, 5))
    for i, what in enumerate(("action", "logp", "value")):  # JAX acts through flax
        _within_floor(tact[i], jact[i], jact32[i], what)
    got, want = _flat(new_ts.critic, new_jts.critic_params)
    _, want32 = _flat(new_ts.critic, new_jts32.critic_params)
    _within_floor(got, want, want32, "critic")
    got, want = _flat(new_ts.actor, new_jts.actor_params)
    np.testing.assert_allclose(got, want, rtol=0, atol=FUSED_PARAM_ATOL)
    critic = ("value_loss", "critic_grad_norm", "explained_var")
    _hold_metrics(tm, jm, jm32, lp_err, critic + RATIO_METRICS)
    for k, v in jm.items():
        if k not in critic + RATIO_METRICS:
            rel = 1e-2 if k.endswith("grad_norm") else FUSED_METRIC_REL
            np.testing.assert_allclose(tm[k], v, rtol=rel, atol=1e-5, err_msg=k)


def test_state_critic_on_hideandseek_is_refused_as_jax_fails():
    """HideAndSeek's critic state holds `state_drones` [E, n, d] beside the
    per-drone cylinders [E, n, k, 5]: the JAX package's `init_carry` fails
    to concatenate them (mupe_tpu/envs/hideandseek.py:732-735), and the
    port refuses the state at `init` with a ValueError naming the groups."""
    jenv = JHideAndSeek(JEnvCfg(num_envs=2, max_episode_length=8, use_tp_net=False))
    jpol = JPolicy(JCfg(critic_input="state", train_every=8), jenv.num_agents, 4,
                   obs_is_dict=True)
    with pytest.raises(TypeError, match="different numbers of dimensions"):
        jinit_carry(jenv, jpol, jax.random.PRNGKey(0))
    env = HideAndSeek(HideAndSeekCfg(num_envs=2, max_episode_length=8, use_tp_net=False),
                      device="cpu")
    pol = MAPPOPolicy(MAPPOCfg(critic_input="state", train_every=8), env.num_agents, 4,
                      obs_is_dict=True, device="cpu")
    with pytest.raises(ValueError, match="state_drones.*cylinders"):
        init_carry(env, pol, torch.Generator().manual_seed(0))
