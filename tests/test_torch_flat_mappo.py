"""MAPPO over flat observations (Hover's) in the PyTorch port against the JAX
package on the CPU: `ValueNorm2`, the flax `MLP` / `FlatEncoder`, the flat
Actor / Critic's `act` and `value_op`, one minibatch's gradients, a whole
`train_op` through `_update_actor` then `_update_critic` (parameters, Adam
moments, `ValueNorm1`, metrics; the safeguard options and AdamW), and a
whole `make_train_iter` on Hover with JAX's env draws and action noise
injected (tests/test_learning.py:63-84, 114, 130, 166 and the JAX package's
drive recipe); MAPPO refusing Hover's dict observations; `harness.train`
on Hover with a resume.

Tolerances.  float32 (`compute_dtype="float32"`): both packages run the same
float32 formulas, so the forward is held to rtol 1e-5, the gradients to
1e-5 of each leaf's scale (measured 5.3e-7), a whole `train_op` (4 Adam
steps) to 2e-6 on the parameters (measured 2.6e-7) and 3e-6 of the largest
moment (measured 1.2e-7 of 0.41; 1.5e-6 of 0.12 under weight decay 0.5),
the metrics to rtol 1e-4 (+1e-7; measured 1.2e-5 on explained_var and
policy_loss, whose values are small).

bfloat16 (the default): flax's `Dense(dtype=bf16)` rounds inputs, kernel
and output, `LayerNorm(dtype=bf16)` keeps float32 statistics and rounds its
output; the port rounds at the same points, and its forward matches flax's
to one bf16 ulp on a few elements.  The backward is another matter: XLA's
CPU transposes a Dense's bias broadcast into a reduction that accumulates
in bfloat16, where torch (and a GPU) accumulates in float32.  So each bf16
quantity is held against the FLOOR, the difference between the JAX
package's own bf16 and float32 results on the same inputs (its bf16
rounding's whole effect): the port's bf16 result is within 2x the floor of
JAX's bf16 (max and mean, per leaf; measured at most 1.03x on a leaf's max
and 0.89x on its mean over the gradients), and, as a control, differs from
the port's own float32 result by at least half the floor on the mean (a
port that ignored `compute_dtype` would differ by nothing).  The forward
is held to 0.5x the floor's max and 0.1x its mean.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from mupe_tpu.envs.hover import Hover as JHover
from mupe_tpu.envs.hover import HoverCfg as JEnvCfg
from mupe_tpu.learning.mappo import MAPPOCfg as JCfg
from mupe_tpu.learning.mappo import MAPPOPolicy as JPolicy
from mupe_tpu.learning.modules.networks import MLP as JMLP
from mupe_tpu.learning.modules.networks import FlatEncoder as JFlatEncoder
from mupe_tpu.learning.rollout import init_carry as jinit_carry
from mupe_tpu.learning.rollout import make_rollout_update_progs
from mupe_tpu.learning.rollout import make_train_iter as jmake_train_iter
from mupe_tpu.learning.valuenorm import ValueNorm2 as JValueNorm2
from mupe_tpu_torch import bridge, harness
from mupe_tpu_torch.envs import Hover, HoverCfg, tree_to
from mupe_tpu_torch.learning import (
    MAPPOCfg,
    MAPPOPolicy,
    ValueNorm2,
    init_carry,
    make_train_iter,
)
from mupe_tpu_torch.learning.modules.networks import MLP, FlatEncoder
from mupe_tpu_torch.utils.checkpoint import to_plain
from test_torch_hideandseek import to_np
from test_torch_hover import inject, jax_step_draws

torch.set_num_threads(1)
E, T, A, LENGTH = 16, 8, 4, 6
BASE = dict(train_every=T, num_minibatches=2, ppo_epochs=2, hidden_units=(64, 64))
DTYPES = ("float32", "bfloat16")
F32_PARAM_ATOL, F32_MOMENT_REL, F32_METRIC_REL = 2e-6, 3e-6, 1e-4
FLOOR_MULT, CONTROL_FRAC = 2.0, 0.5
FWD_MAX_FRAC, FWD_MEAN_FRAC = 0.5, 0.1
VARIANTS = {"target_kl": dict(target_kl=-1.0),
            "entropy_target": dict(entropy_target=50.0, entropy_adapt_speed=0.5),
            "min_log_std": dict(min_log_std=0.3),
            "weight_decay": dict(weight_decay=0.01),
            "weight_decay_0.5": dict(weight_decay=0.5)}


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def _recorder():
    """An optimizer whose state after an update is the gradient it got."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, u), u))


def _adam(opt):
    """The ScaleByAdamState inside a (flattened, chained) optax state."""
    return next(x for x in jax.tree_util.tree_leaves(
        opt, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState))


def _flat(params) -> torch.Tensor:
    return torch.cat([l.reshape(-1) for l in bridge.flat_leaves(params)])


def _split(v, shapes):
    return torch.split(v, [math.prod(s) for s in shapes])


def _hold_floor(got, want, floor, ours_f32, shapes, what):
    """bf16: per leaf, |got - want| within FLOOR_MULT x the floor |want_f32 -
    want| (max and mean) + 1e-6 of the network's scale (float32 rounding,
    where a leaf's floor is ~0), and |got - ours_f32| at least CONTROL_FRAC
    x the floor's mean over the network."""
    ctrl = base = 0.0
    slack = 1e-6 * float(want.abs().max())
    for i, (g, w, f, c) in enumerate(zip(*(_split(v, shapes) for v in (got, want, floor,
                                                                      ours_f32)))):
        err, fl = (g - w).abs(), (f - w).abs()
        assert float(err.max()) <= FLOOR_MULT * float(fl.max()) + slack, (what, i)
        assert float(err.mean()) <= FLOOR_MULT * float(fl.mean()) + slack, (what, i)
        ctrl += float((g - c).abs().sum())
        base += float(fl.sum())
    assert ctrl >= CONTROL_FRAC * base, (what, ctrl, base)


# ------------------------------------------------------------------ ValueNorm2
@pytest.mark.parametrize("subtract_mean", [True, False])
def test_valuenorm2_matches_jax(subtract_mean):
    rng = np.random.default_rng(2)
    jv = JValueNorm2.create((1,), subtract_mean=subtract_mean)
    tv = ValueNorm2.create((1,), subtract_mean=subtract_mean)
    for _ in range(5):
        x = rng.normal(2.0, 4.0, size=(7, 50, 1)).astype(np.float32)
        jv, tv = jv.update(jnp.asarray(x)), tv.update(torch.as_tensor(x))
        for f in ("running_mean", "running_var", "count"):
            np.testing.assert_allclose(_np(getattr(tv, f)), np.asarray(getattr(jv, f)),
                                       rtol=1e-6, err_msg=f)
        np.testing.assert_allclose(_np(tv.normalize(torch.as_tensor(x))),
                                   np.asarray(jv.normalize(jnp.asarray(x))), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(_np(tv.denormalize(torch.as_tensor(x))),
                                   np.asarray(jv.denormalize(jnp.asarray(x))), rtol=1e-5,
                                   atol=1e-5)
    back = bridge.value_norm2(to_np(jv))
    assert back.subtract_mean == subtract_mean
    np.testing.assert_array_equal(_np(back.running_var), np.asarray(jv.running_var))


def test_valuenorm2_welford():
    """tests/test_learning.py's Welford check, on the port."""
    vn = ValueNorm2.create((1,))
    rng = np.random.default_rng(2)
    xs = rng.normal(2.0, 4.0, size=(10, 500, 1)).astype(np.float32)
    for x in xs:
        vn = vn.update(torch.as_tensor(x))
    np.testing.assert_allclose(float(vn.running_mean[0]), xs.mean(), atol=0.05)
    np.testing.assert_allclose(float(torch.sqrt(vn.running_var)[0]), xs.std(), rtol=0.05)


# ------------------------------------------------------------------ MLP / FlatEncoder
def _encoder_leaves(p):
    """A flax FlatEncoder tree → the port's FlatEncoder leaves."""
    p = p["params"]
    mlp = p["MLP_0"]
    leaves = [p["LayerNorm_0"]["scale"], p["LayerNorm_0"]["bias"]]
    for i in range(sum(k.startswith("Dense_") for k in mlp)):
        leaves += [mlp[f"Dense_{i}"]["kernel"], mlp[f"Dense_{i}"]["bias"],
                   mlp[f"LayerNorm_{i}"]["scale"], mlp[f"LayerNorm_{i}"]["bias"]]
    return [torch.as_tensor(np.array(l)) for l in leaves]


def _random_encoder(rng, d, hidden):
    """Unit-scale weights, non-trivial LayerNorm scales and biases."""
    leaves = [torch.as_tensor(rng.uniform(0.5, 1.5, d).astype(np.float32)),
              torch.as_tensor(rng.normal(0, 0.1, d).astype(np.float32))]
    for u in hidden:
        leaves += [torch.as_tensor((rng.normal(size=(d, u)) / np.sqrt(d)).astype(np.float32)),
                   torch.as_tensor(rng.normal(0, 0.1, u).astype(np.float32)),
                   torch.as_tensor(rng.uniform(0.5, 1.5, u).astype(np.float32)),
                   torch.as_tensor(rng.normal(0, 0.1, u).astype(np.float32))]
        d = u
    return leaves


def _flax_tree(leaves, n_layers):
    it = iter(np.asarray(l) for l in leaves)
    tree = {"LayerNorm_0": {"scale": next(it), "bias": next(it)}, "MLP_0": {}}
    for i in range(n_layers):
        tree["MLP_0"][f"Dense_{i}"] = {"kernel": next(it), "bias": next(it)}
        tree["MLP_0"][f"LayerNorm_{i}"] = {"scale": next(it), "bias": next(it)}
    return {"params": tree}


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_mlp_and_flat_encoder_match_flax(compute_dtype):
    rng = np.random.default_rng(0)
    hidden = (256, 256, 256)
    x = rng.normal(size=(512, 1, 20)).astype(np.float32)
    leaves = _random_encoder(rng, 20, hidden)
    tree = _flax_tree(leaves, len(hidden))
    jdt, tdt = jnp.dtype(compute_dtype), getattr(torch, compute_dtype)
    outs = {}
    for dt in ("float32", compute_dtype):
        enc = JFlatEncoder(hidden, dtype=jnp.dtype(dt))
        outs[dt] = np.asarray(enc.apply(tree, jnp.asarray(x)).astype(jnp.float32))
    got = _np(FlatEncoder(20, hidden, dtype=tdt)(torch.as_tensor(x), leaves))
    want = outs[compute_dtype]
    assert FlatEncoder(20, hidden).leaf_shapes() == [tuple(l.shape) for l in leaves]
    # the MLP alone, on the input LayerNorm's output
    mlp_in = rng.normal(size=(64, 20)).astype(np.float32)
    jmlp = JMLP(hidden, dtype=jdt).apply({"params": tree["params"]["MLP_0"]}, jnp.asarray(mlp_in))
    tmlp = MLP(20, hidden, dtype=tdt)(torch.as_tensor(mlp_in), leaves[2:])
    if compute_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(tmlp), np.asarray(jmlp), rtol=1e-5, atol=1e-5)
        return
    floor = np.abs(outs["float32"] - want)
    err = np.abs(got - want)
    assert err.max() <= FWD_MAX_FRAC * floor.max() and err.mean() <= FWD_MEAN_FRAC * floor.mean()
    assert tmlp.dtype == torch.bfloat16
    merr = np.abs(_np(tmlp) - np.asarray(jmlp.astype(jnp.float32)))
    assert merr.mean() <= FWD_MEAN_FRAC * floor.mean()


# ------------------------------------------------------------------ policies
def _policies(compute_dtype, unit_heads=True, **extra):
    """The JAX policy and state (heads at unit gain and a non-zero log_std,
    so every term of the loss moves), and the port's from the same
    parameters."""
    cfg = dict(BASE, compute_dtype=compute_dtype, **extra)
    jpol = JPolicy(JCfg(**cfg), 1, A, obs_is_dict=False)
    obs = np.random.default_rng(9).normal(size=(E, 1, 20)).astype(np.float32)
    jts = jpol.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    ap = jts.actor_params
    if unit_heads:
        ap["params"]["DiagGaussianHead_0"]["Dense_0"]["kernel"] *= 100.0
        ap["params"]["DiagGaussianHead_0"]["log_std"] = jnp.asarray([0.1, -0.2, 0.3, -0.4])
        jts.critic_params["params"]["Dense_0"]["kernel"] *= 100.0
    jts = jts.replace(actor_opt=jpol.actor_tx.init(ap),
                      critic_opt=jpol.critic_tx.init(jts.critic_params))
    tpol = MAPPOPolicy(MAPPOCfg(**cfg), 1, A, obs_is_dict=False, device="cpu")
    return jpol, jts, tpol


def _port_state(tpol, jts, obs):
    return bridge.policy_state(tpol, torch.as_tensor(np.array(obs)),
                               jax.device_get(jts.actor_params),
                               jax.device_get(jts.critic_params))


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_flat_act_and_value_match_jax(compute_dtype):
    obs = np.random.default_rng(1).normal(size=(64, 1, 20)).astype(np.float32)
    res = {}
    for dt in ("float32", compute_dtype):
        jpol, jts, tpol = _policies(dt)
        ts = _port_state(tpol, jts, obs)
        jmean = np.asarray(jpol.act(jts, jnp.asarray(obs), jax.random.PRNGKey(0),
                                    deterministic=True)[0])
        jvalue = np.asarray(jpol.value_op(jts, jnp.asarray(obs)))
        action, logp, value = tpol.act(ts, torch.as_tensor(obs), deterministic=True)
        tvalue = tpol.value_op(ts, torch.as_tensor(obs))
        assert tuple(action.shape) == (64, 1, A) and tuple(logp.shape) == (64, 1, 1)
        np.testing.assert_array_equal(_np(value), _np(tvalue))
        res[dt] = (jmean, jvalue, _np(action), _np(value))
    jmean, jvalue, tmean, tvalue = res[compute_dtype]
    if compute_dtype == "float32":
        np.testing.assert_allclose(tmean, jmean, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tvalue, jvalue, rtol=1e-5, atol=1e-6)
        return
    for got, want, f32 in ((tmean, jmean, res["float32"][0]), (tvalue, jvalue, res["float32"][1])):
        floor, err = np.abs(f32 - want), np.abs(got - want)
        assert err.max() <= FWD_MAX_FRAC * floor.max()
        assert err.mean() <= FWD_MEAN_FRAC * floor.mean()


def _minibatch(rng, m=256):
    return {"obs": rng.normal(size=(m, 1, 20)).astype(np.float32),
            "action": rng.normal(size=(m, 1, A)).astype(np.float32),
            "logp": rng.normal(-6.0, 1.0, (m, 1, 1)).astype(np.float32),
            "value": rng.normal(0.0, 1.0, (m, 1, 1)).astype(np.float32),
            "advantages": rng.normal(0.0, 1.0, (m, 1, 1)).astype(np.float32),
            "returns": rng.normal(0.0, 1.5, (m, 1, 1)).astype(np.float32)}


def _gradients(compute_dtype, mb):
    """(JAX's actor and critic gradients, the port's, the port's info and
    JAX's) for one minibatch of `_update_actor` + `_update_critic`, from
    the same parameters (hidden widths 256 x 3, the recipe's)."""
    jpol, jts, tpol = _policies(compute_dtype, hidden_units=(256, 256, 256))
    jmb = {k: jnp.asarray(v) for k, v in mb.items()}
    _, ja = jpol._update_actor(jts, jmb)
    _, jc = jpol._update_critic(jts, jmb)
    rec = JPolicy(JCfg(**dict(BASE, compute_dtype=compute_dtype, hidden_units=(256, 256, 256))),
                  1, A, obs_is_dict=False)
    rec.actor_tx, rec.critic_tx = _recorder(), _recorder()
    rts = jts.replace(actor_opt=rec.actor_tx.init(jts.actor_params),
                      critic_opt=rec.critic_tx.init(jts.critic_params))
    ga = jax.device_get(rec._update_actor(rts, jmb)[0].actor_opt)
    gc = jax.device_get(rec._update_critic(rts, jmb)[0].critic_opt)
    ts = _port_state(tpol, jts, mb["obs"])
    seen = {}
    tpol._actor_step = lambda ts_, g, stop: seen.__setitem__("a", g)
    tpol._critic_step = lambda ts_, g, stop: seen.__setitem__("c", g)
    info = tpol._update_actor_critic(ts, {k: torch.as_tensor(v) for k, v in mb.items()})
    want = (_flat(ga), torch.as_tensor(np.array(ga["params"]["DiagGaussianHead_0"]["log_std"])),
            _flat(gc))
    got = (seen["a"][0], seen["a"][1], seen["c"][0])
    return want, got, info, {**ja, **jc}, ts


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_flat_minibatch_gradients_match_jax(compute_dtype):
    """One minibatch: the actor's (log_std included) and the critic's
    gradients, and every info metric."""
    mb = _minibatch(np.random.default_rng(3))
    want, got, info, jinfo, ts = _gradients(compute_dtype, mb)
    assert set(info) == set(jinfo)
    if compute_dtype == "float32":
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=1e-5 * float(w.abs().max()))
        for k in jinfo:
            np.testing.assert_allclose(float(info[k]), float(jinfo[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        return
    want32, got32, _, _, ts32 = _gradients("float32", mb)
    for i, shapes in ((0, ts.actor.leaf_shapes()), (2, ts.critic.leaf_shapes())):
        _hold_floor(got[i], want[i], want32[i], got32[i], shapes, f"gradient group {i}")
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-3)  # log_std: f32 head


def _jax_update(compute_dtype, **extra):
    """JAX's rollout on Hover (sampled actions) and its update program on
    it, in `compute_dtype` and in float32 on the same trajectory (the
    floor); the permutations its update draws."""
    jenv = JHover(JEnvCfg(num_envs=E, max_episode_length=LENGTH))
    jpol, _, _ = _policies(compute_dtype, **extra)
    jcarry = jinit_carry(jenv, jpol, jax.random.PRNGKey(0))
    roll, upd = make_rollout_update_progs(jenv, jpol)
    c1, traj, _ = roll(jcarry)
    _, k_train = jax.random.split(c1.key)
    perms = np.stack([np.asarray(jax.random.permutation(k, E * T))
                      for k in jax.random.split(k_train, BASE["ppo_epochs"])])
    out = {compute_dtype: upd(c1, traj)}
    if compute_dtype != "float32":
        jpol32, _, _ = _policies("float32", **extra)
        out["float32"] = make_rollout_update_progs(jenv, jpol32)[1](c1, traj)
    port_traj = {k: torch.as_tensor(np.array(v)) for k, v in traj.items()
                 if k in ("obs", "action", "logp", "value", "reward", "done")}
    return c1, perms, port_traj, {k: (jax.device_get(c.ts), {kk: float(v) for kk, v in m.items()})
                                  for k, (c, m) in out.items()}


def _port_update(compute_dtype, c1, perms, traj, **extra):
    _, _, tpol = _policies(compute_dtype, **extra)
    obs = torch.as_tensor(np.array(c1.obs))
    ts = _port_state(tpol, c1.ts, obs)
    return tpol.train_op(ts, traj, obs, perms=torch.as_tensor(perms))


def _moments(jts, name):
    params = getattr(jts, f"{name}_params")
    adam = _adam(getattr(jts, f"{name}_opt"))
    _, unravel = ravel_pytree(params)
    return bridge.adam_state(jax.device_get(unravel(adam.mu)), jax.device_get(unravel(adam.nu)),
                             adam.count)


def _hold_f32_update(ts, tm, jts, jm):
    assert set(tm) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(float(tm[k]), v, rtol=F32_METRIC_REL, atol=1e-7, err_msg=k)
    for name in ("actor", "critic"):
        net = getattr(ts, name)
        np.testing.assert_allclose(_np(net.flat), _np(_flat(getattr(jts, f"{name}_params"))),
                                   rtol=0, atol=F32_PARAM_ATOL, err_msg=name)
        want, got = _moments(jts, name), getattr(ts, f"{name}_opt")
        assert int(got.count) == int(want.count) > 0
        for g, w in zip(got.mu + got.nu, want.mu + want.nu):
            np.testing.assert_allclose(_np(g), _np(w), rtol=0,
                                       atol=F32_MOMENT_REL * float(w.abs().max()) + 1e-12)
    np.testing.assert_allclose(_np(ts.log_std), np.asarray(
        jts.actor_params["params"]["DiagGaussianHead_0"]["log_std"]), rtol=0, atol=F32_PARAM_ATOL)
    np.testing.assert_allclose(_np(ts.value_norm.running_mean),
                               np.asarray(jts.value_norm.running_mean), rtol=1e-6)
    np.testing.assert_allclose(_np(ts.value_norm.running_mean_sq),
                               np.asarray(jts.value_norm.running_mean_sq), rtol=1e-6)


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_flat_train_op_matches_jax(compute_dtype):
    """A whole `train_op` (2 epochs x 2 minibatches) on JAX's sampled Hover
    rollout: the parameters, both Adam states, ValueNorm1 and every
    metric."""
    c1, perms, traj, upd = _jax_update(compute_dtype)
    ts, tm = _port_update(compute_dtype, c1, perms, traj)
    jts, jm = upd[compute_dtype]
    if compute_dtype == "float32":
        _hold_f32_update(ts, tm, jts, jm)
        return
    jts32, jm32 = upd["float32"]
    ts32, _ = _port_update("float32", c1, perms, traj)
    for name in ("actor", "critic"):
        shapes = getattr(ts, name).leaf_shapes()
        _hold_floor(getattr(ts, name).flat.detach(), _flat(getattr(jts, f"{name}_params")),
                    _flat(getattr(jts32, f"{name}_params")), getattr(ts32, name).flat.detach(),
                    shapes, name)
    for k, v in jm.items():
        floor = abs(jm32[k] - v)
        assert abs(float(tm[k]) - v) <= FLOOR_MULT * floor + 1e-6 * abs(v) + 1e-9, k


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_flat_train_op_options_match_jax(name):
    """float32, as above, with target_kl below the KL's floor (stops after
    the first minibatch), an unreachable entropy target, a log_std floor
    above the initial value, and the critic's AdamW (weight_decay 0.01 and
    0.5)."""
    extra = VARIANTS[name]
    c1, perms, traj, upd = _jax_update("float32", **extra)
    ts, tm = _port_update("float32", c1, perms, traj, **extra)
    jts, jm = upd["float32"]
    _hold_f32_update(ts, tm, jts, jm)
    if name == "target_kl":  # only the first minibatch stepped
        assert float(tm["kl_stop"]) == jm["kl_stop"] == 1.0 and int(ts.actor_opt.count) == 1
    elif name == "entropy_target":
        np.testing.assert_allclose(float(ts.entropy_coef), float(jts.entropy_coef), rtol=1e-6)
    elif name == "min_log_std":
        assert float(ts.log_std.min()) >= 0.3 - 1e-7


def test_flat_train_iter_on_hover_matches_jax():
    """One whole `make_train_iter` on Hover with the sim2real options (action
    and observation noise, payload, latency) and an auto-reset inside the
    rollout, float32: JAX's action noise, env draws and permutations
    injected.  The final env state and observation within rtol 1e-4 (+1e-5
    of scale, test_torch_hover's free run), the episode stats within rtol
    1e-4, then the update as `test_flat_train_op_matches_jax`."""
    env_kw = dict(num_envs=E, max_episode_length=LENGTH, action_noise=True, obs_noise=True,
                  payload=True, latency=True)
    jenv = JHover(JEnvCfg(**env_kw))
    jpol, _, _ = _policies("float32")
    jcarry = jinit_carry(jenv, jpol, jax.random.PRNGKey(4))
    jc2, jm, jstats = jax.jit(jmake_train_iter(jenv, jpol))(jcarry)
    _, k_roll, k_train = jax.random.split(jcarry.key, 3)
    noise, uniforms, normals = [], [], []
    for t, sk in enumerate(jax.random.split(k_roll, T)):
        k_act, k_env = jax.random.split(sk)
        noise.append(np.asarray(jax.random.normal(k_act, (E, 1, A))))
        u, n = jax_step_draws(jenv, k_env, reset=(t + 1) % LENGTH == 0)
        uniforms += u
        normals += n
    perms = np.stack([np.asarray(jax.random.permutation(k, E * T))
                      for k in jax.random.split(k_train, BASE["ppo_epochs"])])

    tenv = Hover(HoverCfg(**env_kw), device="cpu")
    _, _, tpol = _policies("float32")
    ts = _port_state(tpol, jcarry.ts, jcarry.obs)
    carry = init_carry(tenv, tpol, torch.Generator(), ts=ts,
                       env_state=bridge.hover_state(to_np(jcarry.env_state)))
    np.testing.assert_array_equal(_np(carry.obs), np.asarray(jcarry.obs))
    act = tpol.act
    tpol.act = lambda ts_, obs, gen=None, deterministic=False: act(
        ts_, obs, gen, deterministic, noise=torch.as_tensor(noise.pop(0)))
    taken = inject(tenv, uniforms, normals)
    carry, tm, tstats = make_train_iter(tenv, tpol)(carry, perms=torch.as_tensor(perms))
    assert taken() and not noise
    jstats = {k: float(v) for k, v in jstats.items()}
    assert set(tstats) == set(jstats) and float(tstats["episode_count"]) == E
    for k, v in jstats.items():
        np.testing.assert_allclose(float(tstats[k]), v, rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(_np(carry.obs), np.asarray(jc2.obs), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(carry.env_state.drone.pos), np.asarray(jc2.env_state.drone.pos),
                               rtol=1e-4, atol=1e-5)
    _hold_f32_update(carry.ts, tm, jax.device_get(jc2.ts), {k: float(v) for k, v in jm.items()})


# ------------------------------------------------------------------ bridge
def test_bridge_converts_flat_networks_and_their_adam_states():
    jpol, jts, tpol = _policies("float32")
    obs = np.zeros((2, 1, 20), np.float32)
    ts = _port_state(tpol, jts, obs)
    assert [tuple(l.shape) for l in ts.actor.leaves] == ts.actor.leaf_shapes()
    flat, unravel = ravel_pytree(jts.critic_params)
    mu = jnp.arange(flat.shape[0], dtype=jnp.float32)
    st = bridge.adam_state(jax.device_get(unravel(mu)), jax.device_get(unravel(2.0 * mu)), 3)
    np.testing.assert_array_equal(_np(st.mu[0]), _np(_flat(jax.device_get(unravel(mu)))))
    np.testing.assert_array_equal(_np(st.nu[0]), 2.0 * _np(st.mu[0]))
    assert int(st.count) == 3 and len(st.mu) == 1
    sa = bridge.adam_state(jax.device_get(jts.actor_params), jax.device_get(jts.actor_params), 1)
    assert [tuple(t.shape) for t in sa.mu] == [tuple(p.shape) for p in ts.actor_params()]


# ------------------------------------------------------------------ dict observations
@pytest.mark.parametrize("env_kw", [{"dr_mass_scale": (0.8, 1.2)}, {"obs_history_len": 4}],
                         ids=["domain_randomization", "history"])
def test_mappo_refuses_hovers_dict_observations(env_kw):
    """Hover's dict observations (the privileged intrinsics, the history)
    are ppo_adapt's: JAX's MAPPO fails on them, the port's raises naming
    it, through `harness.build` + `init_carry` as through the policy."""
    jenv = JHover(JEnvCfg(num_envs=4, **env_kw))
    jpol = JPolicy(JCfg(train_every=4, num_minibatches=2), 1, A, obs_is_dict=True)
    with pytest.raises(TypeError):
        jax.jit(jmake_train_iter(jenv, jpol))(jinit_carry(jenv, jpol, jax.random.PRNGKey(0)))
    env, policy, _, _ = harness.build(
        "Hover", {k: str(list(v)) if isinstance(v, tuple) else str(v) for k, v in env_kw.items()},
        device="cpu")
    assert policy.obs_is_dict and env.cfg.obs_is_dict
    with pytest.raises(NotImplementedError, match="ppo_adapt"):
        init_carry(env, policy, torch.Generator())


# ------------------------------------------------------------------ harness
def _train(tmp_path, name, *args):
    return harness.train(["task=Hover", "env.num_envs=8", "env.max_episode_length=6",
                          "algo.train_every=8", "algo.num_minibatches=2",
                          "algo.hidden_units=[32,32]", "log_interval=1",
                          f"run_dir={tmp_path}", f"run_name={name}", *args], device="cpu")


def test_harness_trains_hover_and_resumes_exactly(tmp_path):
    """`train(task=Hover)` on the CPU logs Hover's stats; a run of 2
    iterations and a run of 1 resumed for 1 more (`resume_dir`, the full
    carry: flat networks, Adam states, the Hover state, the generator) end
    with the same parameters, bit for bit."""
    m = _train(tmp_path, "straight", "max_iters=2")
    for k in ("stats/pos_error", "stats/return", "stats/episode_count", "value_loss",
              "rollout_fps"):
        assert k in m and math.isfinite(m[k]), k
    _train(tmp_path, "first", "max_iters=1")
    _train(tmp_path, "resumed", "max_iters=1",
           f"resume_dir={tmp_path}/first/checkpoints/full")
    from mupe_tpu_torch.utils.checkpoint import load_checkpoint

    a = load_checkpoint(tmp_path / "straight" / "checkpoints")
    b = load_checkpoint(tmp_path / "resumed" / "checkpoints")
    for net in ("actor", "critic"):
        assert torch.equal(a[net]["flat"], b[net]["flat"]), net
    assert torch.equal(a["critic_opt"]["mu"][0], b["critic_opt"]["mu"][0])


def test_evaluate_stays_hideandseeks():
    """`evaluate` forces `use_eval`, which HoverCfg lacks: it refuses Hover
    as the JAX package's does."""
    with pytest.raises(KeyError, match="use_eval"):
        harness.evaluate(["task=Hover", "env.num_envs=2"], device="cpu")


def test_hover_eval_rows(tmp_path):
    """`eval_interval` evaluates Hover in training (no TP net, no capture
    stat): one greedy episode, every arena finished."""
    m = _train(tmp_path, "ev", "max_iters=1", "eval_interval=1")
    assert math.isfinite(m["eval/pos_error"]) and m["eval/episode_count"] == 8.0


# ------------------------------------------------------------------ the card
@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_flat_act_and_train_op_on_the_card_match_the_cpu(compute_dtype):
    """The flat path on the card (cuBLAS) against the CPU from the same
    weights: act within rtol 1e-4 (f32) or 2e-2 of the scale (bf16), one
    train_op's parameters within 4 Adam steps of lr (sign flips of
    near-zero gradients)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    env = Hover(HoverCfg(num_envs=64, max_episode_length=LENGTH), device="cpu")
    pols = {d: MAPPOPolicy(MAPPOCfg(**dict(BASE, compute_dtype=compute_dtype)), 1, A,
                           obs_is_dict=False, device=d) for d in ("cpu", "cuda")}
    carry = init_carry(env, pols["cpu"], torch.Generator().manual_seed(0))
    ts = {"cpu": carry.ts}
    ts["cuda"] = pols["cuda"].init(carry.obs.cuda(), actor_leaves=carry.ts.actor.leaves,
                                   log_std=carry.ts.log_std,
                                   critic_leaves=carry.ts.critic.leaves)
    out = {d: pols[d].act(ts[d], carry.obs.to(d), deterministic=True) for d in pols}
    scale = float(out["cpu"][0].abs().max())
    tol = 1e-4 * scale if compute_dtype == "float32" else 2e-2 * scale
    assert float((out["cuda"][0].cpu() - out["cpu"][0]).abs().max()) <= tol
    from mupe_tpu_torch.learning import make_rollout

    _, traj, _ = make_rollout(env, pols["cpu"])(carry)
    perms = torch.randperm(64 * T, generator=torch.Generator().manual_seed(1))[None].repeat(2, 1)
    new = {d: pols[d].train_op(ts[d], tree_to(traj, d), carry.obs.to(d), perms=perms)[0]
           for d in pols}
    err = float((new["cuda"].critic.flat.detach().cpu() - new["cpu"].critic.flat.detach())
                .abs().max())
    assert err <= 4 * 2 * 5e-4, err
    assert bool(torch.isfinite(new["cuda"].actor.flat).all())
    assert to_plain(new["cuda"].critic)["flat"].shape == new["cpu"].critic.flat.shape
