"""The PPO family in the PyTorch port against the JAX package on the CPU: one
`act` (JAX's action noise injected) and one whole `train_op` (JAX's
permutations, recomputed from its key) of `ppo` (flat, and with the
privileged branches over {"observation", "intrinsics"}), `ppo_tconv`
(`observation_h`), `transformer` (HideAndSeek's per-agent groups),
`ppo_sdf` and the recurrent `ppo_rnn` (BPTT chunks from stored hidden
states, `is_init` set on some steps), from the same parameters converted
by `bridge`.

Tolerances: every network of the family runs in float32 on both sides, so
as in tests/test_torch_mappo_options.py: `act` within 1e-5 of its scale,
the metrics within 1e-4 relative (+1e-7), the parameters after the update
within 1e-5 of their scale but for a 1e-4 share of them (a gradient within
rounding of zero takes Adam's ±lr step either way), held to the 2 lr a
step such a flip can part them; the transformer's attention key biases,
whose gradient is analytically zero and rounding noise on both sides, are
held to that bound alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.learning.mappo import MAPPOCfg as JCfg
from mupe_tpu.learning.mappo import RolloutBatch
from mupe_tpu.learning.ppo import PPOCfg as JPPOCfg
from mupe_tpu.learning.ppo import PPOPolicy as JPPO
from mupe_tpu.learning.ppo import PPOSDFNavPolicy as JSDF
from mupe_tpu.learning.ppo import PPOTConvPolicy as JTConv
from mupe_tpu.learning.ppo import TransformerPPOPolicy as JTransformer
from mupe_tpu.learning.ppo.ppo_rnn import PPORNNCfg as JRNNCfg
from mupe_tpu.learning.ppo.ppo_rnn import PPORNNPolicy as JRNN
from mupe_tpu.learning.ppo.ppo_rnn import RNNRollout
from mupe_tpu_torch import bridge
from mupe_tpu_torch.learning import MAPPOCfg
from mupe_tpu_torch.learning.ppo import (
    PPOCfg,
    PPOPolicy,
    PPORNNCfg,
    PPORNNPolicy,
    PPOSDFNavPolicy,
    PPOTConvPolicy,
    TransformerPPOPolicy,
)
from test_torch_mappo_options import _flat, _heads_up, _log_std, _np, _t

torch.set_num_threads(1)
T, E, A = 4, 4, 4
BASE = dict(train_every=T, num_minibatches=2, ppo_epochs=1)
F32_REL, METRIC_REL, FLIP_SHARE, LR = 1e-5, 1e-4, 1e-4, 5e-4


def _obs(kind, rng, lead):
    n = 3 if kind == "transformer" else 1
    flat = rng.normal(size=lead + (n, 20)).astype(np.float32)
    if kind in ("ppo", "ppo_rnn"):
        return flat
    if kind == "ppo_priv":
        return {"intrinsics": rng.normal(size=lead + (1, 22)).astype(np.float32),
                "observation": flat}
    if kind == "ppo_tconv":
        return {"observation": flat, "observation_h": rng.normal(
            size=lead + (1, 32, 20)).astype(np.float32)}
    if kind == "ppo_sdf":
        return {"observation": flat,
                "sdf_points": rng.normal(size=lead + (1, 16, 3)).astype(np.float32)}
    # HideAndSeek's per-agent groups, in sorted key order
    return {"cylinders": rng.normal(size=lead + (n, 3, 5)).astype(np.float32),
            "state_others": rng.normal(size=lead + (n, 2, 3)).astype(np.float32),
            "state_self": rng.normal(size=lead + (n, 1, 11)).astype(np.float32)}


def _policies(kind):
    if kind in ("ppo", "ppo_priv"):
        priv = dict(priv_actor=True, priv_critic=True) if kind == "ppo_priv" else {}
        d = kind == "ppo_priv"
        return (JPPO(JPPOCfg(**BASE, **priv), obs_is_dict=d),
                PPOPolicy(PPOCfg(**BASE, **priv), obs_is_dict=d, device="cpu"))
    if kind == "ppo_tconv":
        return (JTConv(JCfg(gamma=0.99, **BASE), obs_is_dict=True),
                PPOTConvPolicy(MAPPOCfg(gamma=0.99, **BASE), obs_is_dict=True, device="cpu"))
    if kind == "ppo_sdf":
        return JSDF(JCfg(gamma=0.99, **BASE)), PPOSDFNavPolicy(MAPPOCfg(gamma=0.99, **BASE),
                                                               device="cpu")
    return (JTransformer(JCfg(**BASE), n_agents=3, per_agent_obs=True),
            TransformerPPOPolicy(MAPPOCfg(**BASE), n_agents=3, per_agent_obs=True,
                                 device="cpu"))


@pytest.mark.parametrize("kind", ["ppo", "ppo_priv", "ppo_tconv", "transformer", "ppo_sdf"])
def test_act_and_train_op_match_jax(kind):
    rng = np.random.default_rng(0)
    jpol, tpol = _policies(kind)
    obs, last_obs = _obs(kind, rng, (T, E)), _obs(kind, rng, (E,))
    n = jpol.n_agents
    jts = jax.jit(jpol.init)(jax.random.PRNGKey(1), last_obs)
    ap, cp = _heads_up(jts.actor_params, 100.0), _heads_up(jts.critic_params, 100.0)
    jts = jts.replace(actor_params=ap, critic_params=cp, actor_opt=jpol.actor_tx.init(ap),
                      critic_opt=jpol.critic_tx.init(cp))
    ts = bridge.policy_state(tpol, _t(last_obs), jax.device_get(ap), jax.device_get(cp))
    # act over the trajectory's steps, from JAX's noise; its samples are the
    # trajectory that train_op learns from
    key = jax.random.PRNGKey(5)
    jact = jax.jit(lambda t_, o: jpol.act(t_, o, key))(jts, obs)
    noise = torch.as_tensor(np.array(jax.random.normal(key, jact[0].shape)))
    tact = tpol.act(ts, _t(obs), noise=noise)
    for j, t in zip(jact, tact):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=0, atol=F32_REL * np.abs(j).max())
    action, logp, value = jact
    batch = RolloutBatch(obs=obs, action=action, logp=logp, value=value,
                         reward=jnp.asarray(rng.normal(size=(T, E, n, 1)).astype(np.float32)),
                         done=jnp.asarray(rng.uniform(size=(T, E, 1)) < 0.2), last_obs=last_obs)
    key = jax.random.PRNGKey(7)
    new_jts, jm = jax.device_get(jax.jit(jpol.train_op)(jts, batch, key))
    perms = np.stack([np.asarray(jax.random.permutation(k, T * E))
                      for k in jax.random.split(key, BASE["ppo_epochs"])])
    traj = {k: _t(getattr(batch, k)) for k in ("obs", "action", "logp", "value", "reward", "done")}
    new_ts, tm = tpol.train_op(ts, traj, _t(last_obs), perms=torch.as_tensor(perms))
    assert set(tm) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(float(tm[k]), float(v), rtol=METRIC_REL, atol=1e-7, err_msg=k)
    steps = BASE["num_minibatches"] * BASE["ppo_epochs"]
    for name in ("actor", "critic"):
        net = getattr(new_ts, name)
        got, want = _flat(net, getattr(new_jts, f"{name}_params"))
        err = np.abs(got - want)
        noise = np.concatenate([np.full(int(np.prod(l.shape)), l.path.endswith("/key/bias"))
                                for l in net.leaf_specs()])
        assert np.mean(err[~noise] > F32_REL * np.abs(want).max()) <= FLIP_SHARE, name
        assert err.max() <= 2 * LR * steps, (name, err.max())
    np.testing.assert_allclose(_np(new_ts.log_std), _log_std(new_jts), rtol=0, atol=F32_REL)


def test_ppo_rnn_act_and_train_op_match_jax():
    """The hidden states threaded by `act`, and the update's BPTT chunks
    (T = 8 steps in chunks of 4) from stored pre-step states, re-zeroed
    where `is_init` is set; metrics `policy_loss` and `value_loss` only."""
    t, e, h = 8, 4, 16
    kw = dict(train_every=t, num_minibatches=2, ppo_epochs=2, train_seq_len=4, rnn_hidden=h)
    jpol, tpol = JRNN(JRNNCfg(**kw)), PPORNNPolicy(PPORNNCfg(**kw), device="cpu")
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(t, e, 1, 12)).astype(np.float32)
    jts = jax.jit(jpol.init)(jax.random.PRNGKey(0), jnp.asarray(obs[0]))
    ap, cp = _heads_up(jts["actor_params"], 100.0), _heads_up(jts["critic_params"], 100.0)
    jts = dict(jts, actor_params=ap, critic_params=cp, actor_opt=jpol.actor_tx.init(ap),
               critic_opt=jpol.critic_tx.init(cp))
    ts = bridge.rnn_policy_state(tpol, _t(obs[0]), jax.device_get(ap), jax.device_get(cp))
    # act through the episode, threading the states (is_init on step 0 and
    # after a done)
    done = rng.uniform(size=(t, e, 1)) < 0.25
    key = jax.random.PRNGKey(3)
    ja = jc = np.zeros((e, 1, h), np.float32)
    ta = tc = torch.zeros((e, 1, h))
    ii = np.ones((e, 1, 1), bool)
    jact = jax.jit(lambda ts_, o, a, c, i, k: jpol.act(ts_, o, a, c, i, k))
    cols = {k: [] for k in ("action", "logp", "value", "is_init", "actor_rnn", "critic_rnn")}
    for step in range(t):
        k = jax.random.fold_in(key, step)
        out = jact(jts, obs[step], ja, jc, ii, k)
        noise = torch.as_tensor(np.array(jax.random.normal(k, out[0].shape)))
        tout = tpol.act(ts, _t(obs[step]), ta, tc, _t(ii), noise=noise)
        for j, tt in zip(out, tout):
            np.testing.assert_allclose(_np(tt), np.asarray(j), rtol=0,
                                       atol=F32_REL * np.abs(np.asarray(j)).max())
        for name, v in zip(cols, (out[0], out[1], out[2], ii, ja, jc)):
            cols[name].append(np.asarray(v))
        ja, jc, ta, tc = np.asarray(out[3]), np.asarray(out[4]), tout[3], tout[4]
        ii = np.broadcast_to(done[step][:, :, None], ii.shape)
    batch = {k: np.stack(v) for k, v in cols.items()}
    batch.update(obs=obs, reward=rng.normal(size=(t, e, 1, 1)).astype(np.float32), done=done,
                 last_obs=obs[-1], last_actor_rnn=ja, last_critic_rnn=jc, last_is_init=ii)
    key = jax.random.PRNGKey(7)
    new_jts, jm = jax.device_get(jax.jit(jpol.train_op)(
        jts, RNNRollout(**{k: jnp.asarray(v) for k, v in batch.items()}), key))
    b = (t // 4) * e
    perms = np.stack([np.asarray(jax.random.permutation(k, b))
                      for k in jax.random.split(key, kw["ppo_epochs"])])
    new_ts, tm = tpol.train_op(ts, {k: _t(np.array(v)) for k, v in batch.items()},
                               perms=torch.as_tensor(perms))
    assert set(tm) == set(jm) == {"policy_loss", "value_loss"}
    for k, v in jm.items():
        np.testing.assert_allclose(float(tm[k]), float(v), rtol=METRIC_REL, atol=1e-7, err_msg=k)
    steps = kw["num_minibatches"] * kw["ppo_epochs"]
    for name in ("actor", "critic"):
        net = getattr(new_ts, name)
        got = _np(net.flat)
        want = _np(torch.cat([l.reshape(-1) for l in bridge.named_leaves(
            new_jts[f"{name}_params"], net)]))
        err = np.abs(got - want)
        assert np.mean(err > F32_REL * np.abs(want).max()) <= FLIP_SHARE, name
        assert err.max() <= 2 * LR * steps, (name, err.max())
    np.testing.assert_allclose(_np(new_ts.log_std), np.asarray(
        new_jts["actor_params"]["params"]["DiagGaussianHead_0"]["log_std"]), rtol=0, atol=F32_REL)
    np.testing.assert_allclose(_np(new_ts.value_norm.running_mean),
                               np.asarray(new_jts["value_norm"].running_mean), rtol=1e-5)
