"""ppo_adapt (RMA) in the PyTorch port against the JAX package on the CPU:
the networks (`IntrinsicsEncoder`, `AdaptationModule`, the conditioned body
by concatenation and by FiLM, `ContextDiscriminator`), two consecutive
`update_adaptation` steps of each of the six losses, one `act` and one
`train_op` in phases "encoder" and "finetune", the three phases through
`harness.train`, and the configurations both packages refuse.  Parameters
are flax's, perturbed (LayerNorm scales and biases off their defaults,
heads at unit gain) and converted by `bridge`; JAX's noise, permutations
and initial parameters are injected, never re-drawn.

Tolerances (float32 on both sides, JAX's side jitted): forward values and
gradients within 1e-5 of each tensor's largest magnitude; the losses
within 1e-5 relative; the parameters after the update steps within 1e-5 of
their scale but for a 1e-4 share, held to the 2 lr a step by which a
gradient within rounding of zero can part them (Adam's step is about lr
whatever the gradient's size); `train_op`'s metrics within 1e-3 relative
(+1e-7): such a flip in a first minibatch's step moves the second's metrics
(ACT_METRIC_REL below).
"""
import csv
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu import harness as jharness
from mupe_tpu.learning.mappo import RolloutBatch
from mupe_tpu.learning.ppo import ppo_adapt as ja
from mupe_tpu.learning.rollout import init_carry as jinit_carry
from mupe_tpu_torch import bridge, harness
from mupe_tpu_torch.learning import init_carry
from mupe_tpu_torch.learning.mappo import net_flats
from mupe_tpu_torch.learning.modules.networks import LeafNet
from mupe_tpu_torch.learning.optim import AdamState
from mupe_tpu_torch.learning.ppo import ppo_adapt as ta
from test_torch_ppo_networks import _perturb

torch.set_num_threads(1)
T, E, A, D, D_INTR, HIST, CTX = 4, 4, 4, 20, 22, 32, 64
BASE = dict(train_every=T, num_minibatches=2, ppo_epochs=1)
F32_REL, FLIP_SHARE, LR = 1e-5, 1e-4, 5e-4
KEY = jax.random.PRNGKey(0)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, np.float32)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


class _Net(LeafNet):
    """A stateless module's leaves (`specs`) in one flat vector; `fn(p,
    *args)` applies it."""

    def __init__(self, specs, fn=None, leaves=None):
        super().__init__()
        self._specs, self.fn = specs, fn
        self._make_flat(leaves, torch.Generator().manual_seed(0))

    def leaf_specs(self):
        return self._specs

    def forward(self, *args):
        return self.fn(self.params(), *args)


def _under(prefix, tree):
    """A flax tree {"params": ...} of a root module, as a parent's submodule."""
    return {"params": {prefix: tree["params"]}} if prefix else tree


def _leaf_dict(specs, tree, prefix):
    """{port path: leaf} from a flax tree rooted at the module."""
    return dict(zip([l.path for l in specs],
                    bridge.named_leaves(_under(prefix, tree), _Net(specs))))


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=F32_REL * max(np.abs(want).max(),
                                                                          1e-30), err_msg=what)


def _hold_module(jmod, jargs, prefix, specs, fn, seed=0):
    """The flax module and the port's function on the same perturbed
    parameters: output and the gradients (parameters and inputs) of a random
    cotangent."""
    params = {"params": _perturb(jax.jit(jmod.init)(KEY, *jargs)["params"],
                                 np.random.default_rng(seed))}
    net = _Net(specs, fn)
    net = _Net(specs, fn, leaves=bridge.named_leaves(_under(prefix, params), net))
    jout = jax.jit(jmod.apply)(params, *jargs)
    cot = np.random.default_rng(seed + 1).normal(size=jout.shape).astype(np.float32)
    argnums = tuple(range(len(jargs) + 1))
    jgrads = jax.jit(jax.grad(lambda p, *a: jnp.sum(jmod.apply(p, *a) * cot), argnums=argnums))(
        params, *jargs)
    targs = [torch.tensor(a, requires_grad=True) for a in jargs]
    out = net(*targs)
    grads = torch.autograd.grad(torch.sum(out * torch.as_tensor(cot)), [net.flat, *targs])
    _close(out, jout, "output")
    for i, (g, j) in enumerate(zip(grads[1:], jgrads[1:])):
        _close(g, j, f"input {i} gradient")
    want = bridge.named_leaves(_under(prefix, jgrads[0]), net)
    for g, w, leaf in zip(torch.split(grads[0], [math.prod(s) for s in net.leaf_shapes()]), want,
                          net.leaf_specs()):
        _close(g.reshape(leaf.shape), w, leaf.path)


def _obs(rng, lead):
    return {"observation": rng.normal(size=lead + (1, D)).astype(np.float32),
            "intrinsics": rng.normal(size=lead + (1, D_INTR)).astype(np.float32),
            "observation_h": rng.normal(size=lead + (1, HIST, D)).astype(np.float32)}


# ------------------------------------------------------------------ networks
def test_intrinsics_encoder_and_adaptation_module_match_flax():
    rng = np.random.default_rng(0)
    intr = rng.normal(size=(6, 1, D_INTR)).astype(np.float32)
    enc = ta.IntrinsicsEncoder(context_dim=CTX)
    _hold_module(ja.IntrinsicsEncoder(CTX), (intr,), "encoder", enc.leaf_specs(D_INTR), enc)
    hist = rng.normal(size=(6, 1, HIST, D)).astype(np.float32)
    mod = ta.AdaptationModule(context_dim=CTX)
    _hold_module(ja.AdaptationModule(CTX), (hist,), "adaptation", mod.leaf_specs(D, HIST), mod)


@pytest.mark.parametrize("mode", ["cat", "film"])
def test_conditioned_body_matches_flax(mode):
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(6, 1, D)).astype(np.float32)
    ctx = rng.normal(size=(6, 1, CTX)).astype(np.float32)
    body = ta.CondBody("_CondBody_0", mode)
    _hold_module(ja._CondBody(mode), (obs, ctx), "_CondBody_0", body.leaf_specs(D, CTX), body)


def test_context_discriminator_matches_flax():
    ctx = np.random.default_rng(2).normal(size=(7, CTX)).astype(np.float32)
    _hold_module(ja.ContextDiscriminator(), (ctx,), None, ta.discriminator_specs(CTX),
                 ta.discriminate)


# ------------------------------------------------------------------ update_adaptation
def _hold_params(got, want, what, steps):
    err = np.abs(_np(got) - _np(want))
    assert np.mean(err > F32_REL * np.abs(_np(want)).max()) <= FLIP_SHARE, what
    assert err.max() <= 2 * 3e-4 * steps + F32_REL * np.abs(_np(want)).max(), (what, err.max())


N_ROWS = 24


@pytest.fixture(scope="module")
def adaptation_setup():
    """One batch, and the perturbed flax parameters of the adaptation module,
    the frozen encoder, actor and critic bodies and the discriminator, with
    the port's counterparts (shared by the six losses)."""
    rng = np.random.default_rng(3)
    o = rng.normal(size=(N_ROWS, D)).astype(np.float32)
    intr = rng.normal(size=(N_ROWS, D_INTR)).astype(np.float32)
    hist = rng.normal(size=(N_ROWS, HIST, D)).astype(np.float32)
    ctx0 = np.zeros((N_ROWS, CTX), np.float32)
    jpol = ja.PPOAdaptivePolicy(ja.PPOAdaptCfg(phase="adaptation"), 1, A)
    tpol = ta.PPOAdaptivePolicy(ta.PPOAdaptCfg(phase="adaptation"), 1, A, device="cpu")

    def init(module, *args, seed):
        return {"params": _perturb(jax.jit(module.init)(jax.random.PRNGKey(seed), *args)[
            "params"], np.random.default_rng(seed))}

    j = dict(ap=init(jpol.adaptation, hist, seed=10), enc=init(jpol.encoder, intr, seed=11),
             actor=init(jpol.actor_body, o, ctx0, seed=12),
             critic=init(jpol.critic_body, o, ctx0, seed=13),
             disc=init(jpol.discriminator, ctx0, seed=14))
    t = dict(enc=_leaf_dict(tpol.encoder.leaf_specs(D_INTR), j["enc"], "encoder"),
             actor=_leaf_dict(tpol.actor_body.leaf_specs(D, CTX), j["actor"], "_AdaptActor_0"),
             critic=_leaf_dict(tpol.critic_body.leaf_specs(D, CTX), j["critic"], "_AdaptCritic_0"))
    t["actor"][ta.LOG_STD_PATH] = torch.as_tensor(
        np.array(j["actor"]["params"]["DiagGaussianHead_0"]["log_std"]))
    return (o, intr, hist), j, t


def _flat_of(specs, tree, prefix):
    return torch.cat([v.reshape(-1) for v in _leaf_dict(specs, tree, prefix).values()])


@pytest.mark.parametrize("variant", ta.ADAPTATION_LOSSES)
def test_update_adaptation_matches_jax(variant, adaptation_setup):
    """Two consecutive steps (the second's Adam state carries the first's
    moments, so the step depends on the gradient's size), from the same
    perturbed adaptation module, frozen encoder, actor and critic bodies
    and, for GAN / LSGAN, discriminator."""
    (o, intr, hist), j, t = adaptation_setup
    jpol = ja.PPOAdaptivePolicy(ja.PPOAdaptCfg(phase="adaptation", adaptation_loss=variant), 1, A)
    tpol = ta.PPOAdaptivePolicy(ta.PPOAdaptCfg(phase="adaptation", adaptation_loss=variant),
                                1, A, device="cpu")
    a_specs, d_specs = tpol.adaptation.leaf_specs(D, HIST), ta.discriminator_specs(CTX)
    gan = variant in ("gan", "lsgan")
    jstep = jax.jit(lambda ap_, ao_, dp_, do_: jpol.update_adaptation(
        ap_, ao_, j["enc"], hist, intr, obs=o, actor_params=j["actor"],
        critic_params=j["critic"], disc_params=dp_, disc_opt=do_))
    ap, j_ao = j["ap"], jpol.adapt_tx.init(j["ap"])
    j_dp, j_do = (j["disc"], jpol.disc_tx.init(j["disc"])) if gan else (None, None)
    t_ap = _flat_of(a_specs, ap, "adaptation")
    t_ao = AdamState.zeros_like([t_ap])
    t_dp = _flat_of(d_specs, j["disc"], None) if gan else None
    t_do = AdamState.zeros_like([t_dp]) if gan else None
    for step in (1, 2):
        jout = jstep(ap, j_ao, j_dp, j_do)
        tout = tpol.update_adaptation(t_ap, t_ao, t["enc"], torch.as_tensor(hist),
                                      torch.as_tensor(intr), obs=torch.as_tensor(o),
                                      actor_params=t["actor"], critic_params=t["critic"],
                                      disc=t_dp, disc_opt=t_do)
        ap, j_ao, t_ap, t_ao = jout[0], jout[1], tout[0], tout[1]
        np.testing.assert_allclose(float(tout[2]), float(jout[2]), rtol=F32_REL, atol=1e-7,
                                   err_msg=f"loss, step {step}")
        _hold_params(t_ap, _flat_of(a_specs, ap, "adaptation"), f"adaptation, step {step}",
                     step)
        if gan:
            j_dp, j_do, t_dp, t_do = jout[3], jout[4], tout[3], tout[4]
            np.testing.assert_allclose(float(tout[5]), float(jout[5]), rtol=F32_REL, atol=1e-7,
                                       err_msg=f"disc_loss, step {step}")
            _hold_params(t_dp, _flat_of(d_specs, j_dp, None), f"discriminator, step {step}",
                         step)


# ------------------------------------------------------------------ act + train_op
# a gradient within rounding of zero can take Adam's step either way (the
# parameters are held to that); with the heads at unit gain, such a flip in
# the first minibatch's step moved the second minibatch's policy loss and
# KL by up to 3.2e-4 relative (finetune with FiLM, whose context multiplies
# the features): the metrics are held within 1e-3 relative here
ACT_METRIC_REL = 1e-3
def _heads_up(tree):
    """The actor's / critic's head at unit gain and a non-zero log_std."""
    p = jax.tree_util.tree_map(lambda x: x, tree["params"])
    if "_AdaptActor_0" in p:
        head = p["_AdaptActor_0"]["DiagGaussianHead_0"]
        head["Dense_0"]["kernel"] = head["Dense_0"]["kernel"] * 100.0
        head["log_std"] = head["log_std"] + jnp.asarray([0.1, -0.2, 0.3, -0.4])
    else:
        dense = p["_AdaptCritic_0"]["Dense_0"]
        dense["kernel"] = dense["kernel"] * 100.0
    return {"params": p}


@pytest.mark.parametrize("phase, mode", [("encoder", "cat"), ("finetune", "film")])
def test_act_and_train_op_match_jax(phase, mode):
    rng = np.random.default_rng(4)
    kw = dict(BASE, phase=phase, condition_mode=mode)
    jpol = ja.PPOAdaptivePolicy(ja.PPOAdaptCfg(**kw), 1, A)
    tpol = ta.PPOAdaptivePolicy(ta.PPOAdaptCfg(**kw), 1, A, device="cpu")
    obs, last_obs = _obs(rng, (T, E)), _obs(rng, (E,))
    jts = jax.jit(jpol.init)(jax.random.PRNGKey(1), last_obs)
    ap, cp = _heads_up(jts.actor_params), _heads_up(jts.critic_params)
    jts = jts.replace(actor_params=ap, critic_params=cp, actor_opt=jpol.actor_tx.init(ap),
                      critic_opt=jpol.critic_tx.init(cp))
    ts = bridge.policy_state(tpol, _t(last_obs), jax.device_get(ap), jax.device_get(cp))
    assert ("adaptation/Dense_0/kernel" in ts.actor.params()) == (phase != "encoder")
    key = jax.random.PRNGKey(5)
    jact = jax.jit(lambda t_, o: jpol.act(t_, o, key))(jts, obs)
    noise = torch.as_tensor(np.array(jax.random.normal(key, jact[0].shape)))
    tact = tpol.act(ts, _t(obs), noise=noise)
    for j, t in zip(jact, tact):
        _close(t, j, "act")
    action, logp, value = jact
    batch = RolloutBatch(obs=obs, action=action, logp=logp, value=value,
                         reward=jnp.asarray(rng.normal(size=(T, E, 1, 1)).astype(np.float32)),
                         done=jnp.asarray(rng.uniform(size=(T, E, 1)) < 0.2), last_obs=last_obs)
    key = jax.random.PRNGKey(7)
    new_jts, jm = jax.device_get(jax.jit(jpol.train_op)(jts, batch, key))
    perms = np.stack([np.asarray(jax.random.permutation(k, T * E))
                      for k in jax.random.split(key, BASE["ppo_epochs"])])
    traj = {k: _t(getattr(batch, k)) for k in ("obs", "action", "logp", "value", "reward", "done")}
    new_ts, tm = tpol.train_op(ts, traj, _t(last_obs), perms=torch.as_tensor(perms))
    assert set(tm) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(float(tm[k]), float(v), rtol=ACT_METRIC_REL, atol=1e-7,
                                   err_msg=k)
    steps = BASE["num_minibatches"] * BASE["ppo_epochs"]
    for name in ("actor", "critic"):
        net = getattr(new_ts, name)
        want = torch.cat([l.reshape(-1) for l in bridge.leaves_of(
            net, getattr(new_jts, f"{name}_params"))])
        err = np.abs(_np(torch.cat(net_flats(net))) - _np(want))
        assert np.mean(err > F32_REL * np.abs(_np(want)).max()) <= FLIP_SHARE, name
        assert err.max() <= 2 * LR * steps, (name, err.max())
    _close(new_ts.log_std, bridge.actor_log_std(new_jts.actor_params), "log_std")


# ------------------------------------------------------------------ harness
TINY = ["task=Hover", "env.num_envs=8", "env.max_episode_length=16", "log_interval=1",
        "save_interval=-1", "algo.train_every=8", "algo.num_minibatches=2", "algo=ppo_adapt"]


@pytest.mark.parametrize("loss", ["mse", "lsgan"])
def test_train_runs_the_three_phases(tmp_path, loss):
    """4 iterations: 2 of PPO with the encoder, 1 adaptation step, 1 of
    finetuning; the last row is phase 3, every logged value finite, the
    adaptation row carries its losses and the run ends with its checkpoints."""
    assert harness.rma_phase_lengths(4) == (2, 1, 1) and harness.rma_phase_lengths(10) == (5, 2, 3)
    m = harness.train([*TINY, f"run_dir={tmp_path}", "run_name=rma", "max_iters=4",
                       f"algo.adaptation_loss={loss}"], device="cpu")
    assert m["rma_phase"] == 3.0
    assert all(math.isfinite(v) for k, v in m.items() if not k.startswith("stats/"))
    with open(tmp_path / "rma" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [float(r["rma_phase"]) for r in rows] == [1.0, 1.0, 2.0, 3.0]
    adapt = rows[2]
    assert math.isfinite(float(adapt["adaptation_loss"]))
    assert ("disc_loss" in adapt and math.isfinite(float(adapt["disc_loss"]))) == (loss == "lsgan")
    assert (tmp_path / "rma" / "checkpoints" / "step_4").exists()
    assert (tmp_path / "rma" / "checkpoints" / "full" / "step_4").exists()


def test_refusals_match_jax():
    """Flat observations are refused by both registries with JAX's
    ValueError; on HideAndSeek the policy builds in both, and both fail at
    init_carry with KeyError: the observation has no 'intrinsics'."""
    with pytest.raises(ValueError, match="dict observations"):
        jharness.build("Hover", {"num_envs": 2}, algo="ppo_adapt")
    with pytest.raises(ValueError, match="dict observations"):
        harness.build("Hover", {"num_envs": 2}, algo="ppo_adapt", device="cpu")
    jenv, jpol, _, _ = jharness.build("HideAndSeek", {"num_envs": 2}, algo="ppo_adapt")
    with pytest.raises(KeyError, match="intrinsics"):
        jinit_carry(jenv, jpol, KEY)
    env, pol, _, _ = harness.build("HideAndSeek", {"num_envs": 2}, algo="ppo_adapt", device="cpu")
    assert type(pol).__name__ == type(jpol).__name__ == "PPOAdaptivePolicy"
    with pytest.raises(KeyError, match="intrinsics"):
        init_carry(env, pol, torch.Generator().manual_seed(0))
