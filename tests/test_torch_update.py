"""The port's PPO and TP update steps against the JAX package, from the same
parameters converted by `bridge`.

* One `_update_joint_flat` minibatch: the actor (log_std included) and
  critic gradients against JAX's, recorded by an optimizer that stores the
  gradients it is given, and every info metric.  The JAX side's encoder
  gradient off-TPU is autodiff of `reference_apply`; the port's is
  `reference_backward` (the kernel's rounding points): within 3e-2 of each
  leaf's scale + 1e-4, as tests/test_fused_encoder.py holds the two
  (measured up to 1.1e-2 of scale); the key-bias gradient, analytically
  zero and noise on both sides, within 1e-3 of the network's largest
  gradient (measured 2e-4); the metrics within 1e-3 relative (+1e-6;
  measured up to 1.4e-4: both sides run `reference_apply`'s rounding points,
  in another order), the gradient norms within 1e-2 (measured 1.2e-3).
* clip + Adam from identical gradients against optax (`optax.flatten(chain(
  clip_by_global_norm(10), adam))`, several steps, clipped and not): within
  1e-6 relative, or 1e-6 of the scale (the learning rate for the updates,
  the largest first moment for it) where the first moment cancels: the
  clip's norm sums in another order, and a cancelling moment magnifies its
  last-bit difference (measured 1.1e-7 of the learning rate).
* `_update_tp` against JAX's kernel path (`tp_apply_t`, selected by making
  `jax.default_backend` report "tpu" with the Pallas calls switched off, so
  `_reference_t` runs): TP_loss within 1e-5 relative, the gradients within
  3e-2 of each leaf's scale (JAX's autodiff rounds its cotangents at other
  points than `_tp_bwd_kernel_t`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

import mupe_tpu.ops.fused_encoder as jfe
import mupe_tpu.ops.tp_lstm as jtl
from mupe_tpu.learning.mappo import MAPPOCfg as JCfg
from mupe_tpu.learning.mappo import MAPPOPolicy as JPolicy
from mupe_tpu.learning.mappo import RolloutBatch
from mupe_tpu.learning.mappo import compute_pack_meta as jmeta
import mupe_tpu_torch.learning.mappo as tmappo
from mupe_tpu_torch import bridge
from mupe_tpu_torch.learning import AdamState, MAPPOCfg, MAPPOPolicy, compute_pack_meta
from mupe_tpu_torch.learning.mappo import pack_rows, unpack_rows
from mupe_tpu_torch.learning.optim import adam_updates, clip_by_global_norm
from mupe_tpu_torch.ops.fused_encoder import split_flat

torch.set_num_threads(1)
E, N_AG, A = 16, 3, 4
GRAD_REL, GRAD_ABS, NOISE_REL = 3e-2, 1e-4, 1e-3
INFO_KEYS = ("policy_loss", "actor_grad_norm", "entropy", "ESS", "value_loss",
             "critic_grad_norm", "explained_var", "approx_kl")


def _obs(rng, lead):
    return {"state_self": rng.normal(size=lead + (N_AG, 1, 35)).astype(np.float32),
            "cylinders": rng.normal(size=lead + (N_AG, 3, 5)).astype(np.float32),
            "state_others": rng.normal(size=lead + (N_AG, 2, 3)).astype(np.float32)}


def _recorder():
    """An optimizer whose state after an update is the gradient it got."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, u), u))


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    jpol = JPolicy(JCfg(use_tp_net=True), n_agents=N_AG, action_dim=A, obs_is_dict=True,
                   tp_input_dim=16)
    obs = _obs(rng, (E,))
    jts = jpol.init(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in obs.items()})
    # heads at unit gain and a non-zero log_std, so every term of the loss moves
    ap = jts.actor_params
    ap["params"]["DiagGaussianHead_0"]["Dense_0"]["kernel"] *= 100.0
    ap["params"]["DiagGaussianHead_0"]["log_std"] = jnp.asarray([0.1, -0.2, 0.3, -0.4])
    jts.critic_params["params"]["Dense_0"]["kernel"] *= 100.0
    jts = jts.replace(actor_opt=jpol.actor_tx.init(ap),
                      critic_opt=jpol.critic_tx.init(jts.critic_params))
    tpol = MAPPOPolicy(MAPPOCfg(use_tp_net=True), n_agents=N_AG, action_dim=A,
                       obs_is_dict=True, tp_input_dim=16, device="cpu")
    tobs = {k: torch.as_tensor(v) for k, v in obs.items()}
    tts = bridge.policy_state(tpol, tobs, jax.device_get(ap), jax.device_get(jts.critic_params),
                              jax.device_get(jts.tp_params))
    return jpol, jts, tpol, tts, obs


def _minibatch(pair, seed=1):
    jpol, jts, tpol, tts, obs = pair
    rng = np.random.default_rng(seed)
    meta = jmeta({k: jnp.asarray(v) for k, v in obs.items()}, N_AG, A)
    mobs = _obs(rng, (E,))
    x = np.concatenate([mobs[n].reshape(E, N_AG, -1) for n in meta.names], -1).reshape(E * N_AG, -1)
    s = E * N_AG
    action = rng.normal(size=(s, A)).astype(np.float32)
    mb = {"obs_rows": x, "action": action,
          "logp": rng.normal(-6.0, 1.0, (s,)).astype(np.float32),
          "value": rng.normal(0.0, 1.0, (s,)).astype(np.float32),
          "advantages": rng.normal(0.0, 1.0, (s,)).astype(np.float32),
          "returns": rng.normal(0.0, 1.5, (s,)).astype(np.float32)}
    return meta, mb


def test_joint_minibatch_gradients_and_metrics_match_jax(pair):
    jpol, jts, tpol, tts, obs = pair
    meta, mb = _minibatch(pair)
    jmb = {k: jnp.asarray(v) for k, v in mb.items()}
    _, jinfo = jpol._update_joint_flat(jts, jmb, meta)
    rec = JPolicy(JCfg(use_tp_net=True), n_agents=N_AG, action_dim=A, obs_is_dict=True,
                  tp_input_dim=16)
    rec.actor_tx, rec.critic_tx = _recorder(), _recorder()
    rts = jts.replace(actor_opt=rec.actor_tx.init(jts.actor_params),
                      critic_opt=rec.critic_tx.init(jts.critic_params))
    grec, _ = rec._update_joint_flat(rts, jmb, meta)
    ja = jax.device_get(grec.actor_opt)
    jc = jax.device_get(grec.critic_opt)
    tmb = {k: torch.as_tensor(v) for k, v in mb.items()}
    ga, gc, _ = tpol._joint_grads(tts, tmb)
    want_a = [torch.cat([l.reshape(-1) for l in bridge.encoder_leaves(ja)]),
              bridge.actor_log_std(ja)]
    want_c = [torch.cat([l.reshape(-1) for l in bridge.encoder_leaves(jc)])]
    for got, want, spec in ((ga[0], want_a[0], tts.actor.spec), (gc[0], want_c[0], tts.critic.spec)):
        net_scale = float(want.abs().max())
        leaves = list(zip(split_flat(spec, got), split_flat(spec, want)))
        for i, (gl, wl) in enumerate(leaves):
            err = float((gl - wl).abs().max())
            if i == len(leaves) - 15:  # the key bias: analytically zero, noise on both sides
                assert err < NOISE_REL * net_scale, (i, err, net_scale)
            else:
                assert err < GRAD_REL * float(wl.abs().max()) + GRAD_ABS, (i, err)
    np.testing.assert_allclose(ga[1].numpy(), want_a[1].numpy(), rtol=1e-4, atol=1e-6)
    tinfo = tpol._update_joint_flat(_fresh_state(tpol, pair), tmb)
    assert set(tinfo) == set(jinfo)
    for k in INFO_KEYS:
        rtol = 1e-2 if k.endswith("grad_norm") else 1e-3
        np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]), rtol=rtol, atol=1e-6,
                                   err_msg=k)


def _fresh_state(tpol, pair):
    """A fresh port state from the JAX parameters (train steps update in place)."""
    jpol, jts, _, _, obs = pair
    return bridge.policy_state(tpol, {k: torch.as_tensor(v) for k, v in obs.items()},
                               jax.device_get(jts.actor_params),
                               jax.device_get(jts.critic_params), jax.device_get(jts.tp_params))


@pytest.mark.parametrize("scale", [0.01, 30.0])
def test_clip_and_adam_match_optax(scale):
    """Several steps of clip-by-global-norm(10) + Adam on an (encoder, log_std)
    group from identical gradients; scale 30 makes the clip bite."""
    rng = np.random.default_rng(int(scale * 100))
    params = (rng.normal(size=(1000,)).astype(np.float32), rng.normal(size=(4,)).astype(np.float32))
    tx = optax.flatten(optax.chain(optax.clip_by_global_norm(10.0), optax.adam(5e-4)))
    jstate = tx.init(params)
    tstate = AdamState.zeros_like([torch.as_tensor(p) for p in params])
    for _ in range(3):
        grads = tuple((scale * rng.normal(size=p.shape)).astype(np.float32) for p in params)
        jupd, jstate = tx.update(grads, jstate, params)
        tupd, tstate = adam_updates(clip_by_global_norm([torch.as_tensor(g) for g in grads], 10.0),
                                    tstate, 5e-4)
        for t, j in zip(tupd, jupd):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6 * 5e-4)
        adam = jstate[1][0]
        _, unravel = ravel_pytree(params)
        for t, j in zip(tstate.mu, unravel(adam.mu)):
            j = np.asarray(j)
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=1e-6 * np.abs(j).max())
        for t, j in zip(tstate.nu, unravel(adam.nu)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-15)
        assert int(tstate.count) == int(adam.count)


def test_bridge_converts_the_flattened_adam_state(pair):
    """`bridge.adam_state` maps optax's flattened moments (unravelled into
    the parameter trees) onto the port's parameter groups."""
    jpol, jts, tpol, tts, obs = pair
    _, unravel = ravel_pytree(jts.actor_params)
    flat, _ = ravel_pytree(jts.actor_params)
    mu = jnp.arange(flat.shape[0], dtype=jnp.float32)
    st = bridge.adam_state(jax.device_get(unravel(mu)), jax.device_get(unravel(2.0 * mu)), 7)
    want = bridge.encoder_leaves(jax.device_get(unravel(mu)))
    assert [tuple(t.shape) for t in st.mu] == [tuple(p.shape) for p in tts.actor_params()]
    np.testing.assert_array_equal(st.mu[0].numpy(),
                                  torch.cat([l.reshape(-1) for l in want]).numpy())
    np.testing.assert_array_equal(st.nu[1].numpy(), 2.0 * st.mu[1].numpy())
    assert int(st.count) == 7
    _, tunravel = ravel_pytree(jts.tp_params)
    tflat, _ = ravel_pytree(jts.tp_params)
    tst = bridge.adam_state(jax.device_get(tunravel(tflat)), jax.device_get(tunravel(tflat)), 1)
    for t, p in zip(tst.mu, tts.tp_net.leaves()):
        np.testing.assert_array_equal(t.numpy(), p.detach().numpy())


def test_pack_rows_match_the_jax_layout():
    from mupe_tpu.learning.mappo import pack_rollout_row

    rng = np.random.default_rng(3)
    obs = _obs(rng, (2, 5))
    action = rng.normal(size=(2, 5, N_AG, A)).astype(np.float32)
    logp, value = (rng.normal(size=(2, 5, N_AG, 1)).astype(np.float32) for _ in range(2))
    adv, ret = (rng.normal(size=(2, 5 * N_AG)).astype(np.float32) for _ in range(2))
    jm = jmeta({k: jnp.asarray(v[0]) for k, v in obs.items()}, N_AG, A)
    tm = compute_pack_meta({k: torch.as_tensor(v[0]) for k, v in obs.items()}, N_AG, A)
    assert (tm.names, tm.groups, tm.total, tm.off_adv) == (jm.names, jm.groups, jm.total, jm.off_adv)
    jrows = np.concatenate([np.asarray(pack_rollout_row(
        jm, {k: jnp.asarray(v[t]) for k, v in obs.items()}, jnp.asarray(action[t]),
        jnp.asarray(logp[t]), jnp.asarray(value[t]))) for t in range(2)])
    jrows[:, jm.off_adv : jm.off_adv + N_AG] = adv.reshape(10, N_AG)
    jrows[:, jm.off_ret : jm.off_ret + N_AG] = ret.reshape(10, N_AG)
    t = lambda a: torch.as_tensor(a)
    rows = pack_rows(tm, {k: t(v) for k, v in obs.items()}, t(action), t(logp), t(value),
                     t(adv), t(ret))
    np.testing.assert_array_equal(rows.numpy(), jrows)
    mb = unpack_rows(tm, rows[:4])
    assert tuple(mb["obs_rows"].shape) == (12, 56) and tuple(mb["action"].shape) == (12, A)


def test_update_tp_matches_jax_kernel_path(pair, monkeypatch):
    jpol, jts, tpol, tts, obs = pair
    rng = np.random.default_rng(5)
    t_len = 12
    tp_input = rng.normal(size=(t_len, E, 10, 16)).astype(np.float32)
    tp_gt = rng.uniform(-1, 1, (t_len, E, 3)).astype(np.float32)
    done = rng.random((t_len, E, 1)) < 0.05
    tp_done = rng.random((t_len, E, 1)) < 0.9
    batch = RolloutBatch(obs=None, action=None, logp=None, value=None, reward=None,
                         done=jnp.asarray(done), last_obs=None, tp_input=jnp.asarray(tp_input),
                         tp_gt=jnp.asarray(tp_gt), tp_done=jnp.asarray(tp_done))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jtl, "_on_tpu", lambda: False)
    monkeypatch.setattr(jfe, "_on_tpu", lambda: False)
    rec = JPolicy(JCfg(use_tp_net=True), n_agents=N_AG, action_dim=A, obs_is_dict=True,
                  tp_input_dim=16)
    rec.tp_tx = _recorder()
    _, jm = jpol._update_tp(jts, batch, jax.random.PRNGKey(0))
    grec, _ = rec._update_tp(jts.replace(tp_opt=rec.tp_tx.init(jts.tp_params)), batch,
                             jax.random.PRNGKey(0))
    want = bridge.tp_leaves(jax.device_get(grec.tp_opt))
    ts = _fresh_state(tpol, pair)
    traj = {"tp_input": torch.as_tensor(tp_input), "tp_gt": torch.as_tensor(tp_gt),
            "done": torch.as_tensor(done), "tp_done": torch.as_tensor(tp_done)}
    leaves = list(ts.tp_net.leaves())
    before = [l.detach().clone() for l in leaves]
    seen = []

    def recording_adam(grads, state, lr):
        seen.append([g.clone() for g in grads])
        return adam_updates(grads, state, lr)

    monkeypatch.setattr(tmappo, "adam_updates", recording_adam)
    tm = tpol._update_tp(ts, traj)
    np.testing.assert_allclose(float(tm["TP_loss"]), float(jm["TP_loss"]), rtol=1e-5)
    for g, w in zip(seen[0], want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) < GRAD_REL * float(w.abs().max()) + 1e-7
    # Adam's first step moves each parameter by about lr = 1e-4
    moved = [float((l.detach() - b).abs().max()) for l, b in zip(leaves, before)]
    assert max(moved) <= 1.001e-4 and min(moved) > 0
