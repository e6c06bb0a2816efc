"""One training iteration of the port (`make_train_iter`: rollout + `train_op`)
against the JAX package's `make_split_train_iter` programs, on the JAX
package's small configuration (tests/test_pack_rollout.py: 8 arenas, 8
steps, 2 minibatches, 2 PPO epochs, TP net on), from the same converted env
state and parameters, with the minibatch permutations JAX draws.

Both rollouts are deterministic (the port cannot draw JAX's noise).  The JAX
policy acts through `reference_apply` (`use_fused_act`), its env predicts
through `tp_apply_t` (`KernelTPEnv`) and its TP update takes the kernel path
(`jax.default_backend` reports "tpu" while the update program is traced, the
Pallas calls switched off): the math the port's kernels compute.

Tolerances: the metrics within 2e-3 relative (+1e-5), the gradient norms
within 1e-2 (the encoder gradients' rounding points differ: JAX's autodiff
of `reference_apply` against the kernel's backward, see test_torch_update);
the parameters after the step within 3e-3 absolute, the JAX package's own
bound for one iteration (tests/test_pack_rollout.py).  Parameter deltas are
not compared element by element: Adam's first step moves each parameter by
about ±lr whatever the gradient's size, so a near-zero gradient of either
sign flips a whole lr.  The key bias's gradient is analytically zero, so
both sides step it on rounding noise: it is held to the 4e-3 that four
steps of about ±lr each way can part it (measured 3.3e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mupe_tpu.ops.fused_encoder as jfe
import mupe_tpu.ops.tp_lstm as jtl
from mupe_tpu.envs.hideandseek import HideAndSeekCfg as JEnvCfg
from mupe_tpu.learning.mappo import MAPPOCfg as JCfg
from mupe_tpu.learning.mappo import MAPPOPolicy as JPolicy
from mupe_tpu.learning.rollout import init_carry as jinit_carry
from mupe_tpu.learning.rollout import make_rollout_update_progs
from mupe_tpu_torch import bridge
from mupe_tpu_torch.envs import HideAndSeek, HideAndSeekCfg
from mupe_tpu_torch.learning import MAPPOCfg, MAPPOPolicy, init_carry, make_train_iter
from test_torch_hideandseek import KernelTPEnv, to_np

torch.set_num_threads(1)
E, STEPS = 8, 8
BASE = dict(train_every=STEPS, num_minibatches=2, ppo_epochs=2, use_tp_net=True)
METRICS = ("policy_loss", "value_loss", "entropy", "ESS", "approx_kl", "explained_var",
           "actor_grad_norm", "critic_grad_norm", "advantages_mean", "advantages_std",
           "TP_loss", "action_norm", "value_running_mean")
ACTOR_NOISE = ("policy_loss", "approx_kl", "ESS", "actor_grad_norm")
METRIC_REL, NORM_REL, PARAM_ATOL = 2e-3, 1e-2, 3e-3
KEY_BIAS_ATOL = 2 * 4 * 5e-4  # two opposite moves of about lr in each of 4 steps
VARIANTS = {"target_kl": dict(target_kl=-1.0),
            "entropy_target": dict(entropy_target=50.0, entropy_adapt_speed=0.5),
            "min_log_std": dict(min_log_std=0.3)}


@pytest.fixture(scope="module")
def run():
    jenv = KernelTPEnv(JEnvCfg(num_envs=E, max_episode_length=16))
    jpol = JPolicy(JCfg(**BASE, use_fused_act=True), n_agents=3, action_dim=4,
                   obs_is_dict=True, tp_input_dim=16)
    jcarry = jinit_carry(jenv, jpol, jax.random.PRNGKey(0))
    rollouts = {det: make_rollout_update_progs(jenv, jpol, deterministic=det)[0](jcarry)[:2]
                for det in (True, False)}
    # the permutations of train_op's epochs (update_prog splits the carry key)
    _, k_train = jax.random.split(rollouts[True][0].key)
    perms = np.stack([np.asarray(jax.random.permutation(k, E * STEPS))
                      for k in jax.random.split(k_train, BASE["ppo_epochs"])])
    updates = {}
    for name, extra in [("base", {})] + list(VARIANTS.items()):
        pol = JPolicy(JCfg(**BASE, use_fused_act=True, **extra), n_agents=3, action_dim=4,
                      obs_is_dict=True, tp_input_dim=16)
        # built before the patch: the TPU compiler options are chosen here
        _, update_prog = make_rollout_update_progs(jenv, pol, deterministic=True)
        for det in (True, False) if name == "base" else (False,):
            c, traj = rollouts[det]
            if "entropy_target" in extra:
                c = c.replace(ts=c.ts.replace(entropy_coef=jnp.asarray(0.001, jnp.float32)))
            with pytest.MonkeyPatch.context() as mp:  # traced at the first call
                mp.setattr(jax, "default_backend", lambda: "tpu")
                mp.setattr(jtl, "_on_tpu", lambda: False)
                mp.setattr(jfe, "_on_tpu", lambda: False)
                c3, metrics = update_prog(c, traj)
            updates[name, det] = (jax.device_get(c3.ts),
                                  {k: float(v) for k, v in metrics.items()})
    stoch_carry, stoch_traj = rollouts[False]
    return jcarry, perms, updates, _port_traj(jpol, stoch_carry, stoch_traj)


def _port_traj(jpol, carry, traj):
    """The JAX rollout's trajectory (packed rows) as the port's traj dict,
    with its last observation."""
    obs = to_np(carry.obs)
    meta = jpol.pack_meta_for(carry.obs)
    t = {k: torch.as_tensor(np.array(v)) for k, v in to_np(traj).items()
         if k in ("value", "reward", "done", "tp_input", "tp_gt", "tp_done")}
    rows = np.array(traj["packed"])                     # [T, E, total]
    n = meta.n_agents
    x = rows[..., : meta.obs_cols].reshape(STEPS, E, n, meta.obs_dim)
    t["obs"], off = {}, 0
    for name, (k, d) in zip(meta.names, meta.groups):
        t["obs"][name] = torch.as_tensor(x[..., off : off + k * d].reshape(STEPS, E, n, k, d))
        off += k * d
    t["action"] = torch.as_tensor(rows[..., meta.off_action : meta.off_logp].reshape(STEPS, E, n, 4))
    t["logp"] = torch.as_tensor(rows[..., meta.off_logp : meta.off_value].reshape(STEPS, E, n, 1))
    return t, bridge.tensors(obs)


def _port(jcarry, extra=None):
    tenv = HideAndSeek(HideAndSeekCfg(num_envs=E, max_episode_length=16), device="cpu")
    tpol = MAPPOPolicy(MAPPOCfg(**BASE, **(extra or {})), n_agents=3, action_dim=4,
                       obs_is_dict=True, tp_input_dim=16, device="cpu")
    obs = bridge.tensors(to_np(jcarry.obs))
    ts = bridge.policy_state(tpol, obs, jax.device_get(jcarry.ts.actor_params),
                             jax.device_get(jcarry.ts.critic_params),
                             jax.device_get(jcarry.ts.tp_params))
    carry = init_carry(tenv, tpol, torch.Generator().manual_seed(0), ts=ts,
                       env_state=bridge.env_state(to_np(jcarry.env_state)))
    return tenv, tpol, carry


def _params_close(ts, jts):
    got = [*ts.actor.leaves, ts.log_std, *ts.critic.leaves, *ts.tp_net.leaves()]
    want = [*bridge.encoder_leaves(jts.actor_params), bridge.actor_log_std(jts.actor_params),
            *bridge.encoder_leaves(jts.critic_params), *bridge.tp_leaves(jts.tp_params)]
    n_enc = len(ts.actor.leaves)
    key_bias = {n_enc - 15, 2 * n_enc + 1 - 15}
    for i, (g, w) in enumerate(zip(got, want)):
        atol = KEY_BIAS_ATOL if i in key_bias else PARAM_ATOL
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=0, atol=atol,
                                   err_msg=f"parameter leaf {i}")


def _metrics_close(tm, jm, keys=METRICS):
    for k in keys:
        rel = NORM_REL if k.endswith("grad_norm") else METRIC_REL
        np.testing.assert_allclose(float(tm[k]), jm[k], rtol=rel, atol=1e-5, err_msg=k)


def test_train_iter_matches_jax_split_train_iter(run):
    """Both packages' whole iteration with deterministic rollouts.  There the
    actor's gradient is (action - mean) / sigma^2 with action = the rollout's
    mean: rounding noise between two forwards (1% of the output on this CPU
    for JAX's two compiled programs), so the actor-side metrics are held in
    `test_train_op_on_the_jax_trajectory_matches_jax`, on a sampled rollout."""
    jcarry, perms, updates, _ = run
    jts, jm = updates["base", True]
    tenv, tpol, carry = _port(jcarry)
    carry, tm, stats = make_train_iter(tenv, tpol, deterministic=True)(
        carry, perms=torch.as_tensor(perms))
    assert set(tm) == set(jm)
    _metrics_close(tm, jm, [k for k in METRICS if k not in ACTOR_NOISE])
    _params_close(carry.ts, jts)
    assert int(carry.ts.actor_opt.count) == int(carry.ts.critic_opt.count) == 4
    assert int(carry.ts.tp_opt.count) == 1
    np.testing.assert_allclose(carry.ts.value_norm.running_mean.numpy(),
                               np.asarray(jts.value_norm.running_mean), rtol=1e-4)
    assert float(stats["episode_count"]) == 0.0


def test_train_op_on_the_jax_trajectory_matches_jax(run):
    """`train_op` on JAX's sampled rollout (converted) against JAX's update
    program on it: every metric and the parameters."""
    jcarry, perms, updates, (traj, last_obs) = run
    jts, jm = updates["base", False]
    _, tpol, carry = _port(jcarry)
    ts, tm = tpol.train_op(carry.ts, traj, last_obs, perms=torch.as_tensor(perms))
    assert set(tm) == set(jm)
    _metrics_close(tm, jm)
    _params_close(ts, jts)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_safeguard_options_match_jax(run, name):
    """On JAX's sampled rollout: target_kl below the KL's floor stops after
    the first minibatch; an unreachable entropy target grows the
    coefficient; a log_std floor above the initial value holds."""
    jcarry, perms, updates, (traj, last_obs) = run
    jts, jm = updates[name, False]
    _, tpol, carry = _port(jcarry, VARIANTS[name])
    ts, tm = tpol.train_op(carry.ts, traj, last_obs, perms=torch.as_tensor(perms))
    assert set(tm) == set(jm)
    _metrics_close(tm, jm)
    _params_close(ts, jts)
    if name == "target_kl":
        assert float(tm["kl_stop"]) == jm["kl_stop"] == 1.0
    elif name == "entropy_target":
        np.testing.assert_allclose(float(ts.entropy_coef), float(jts.entropy_coef), rtol=1e-5)
        assert float(ts.entropy_coef) > 0.001
    else:
        assert float(ts.log_std.min()) >= 0.3 - 1e-7
