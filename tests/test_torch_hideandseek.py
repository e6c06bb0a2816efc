"""HideAndSeek step of the PyTorch port against the JAX package.

Teacher-forced parity: from a JAX `reset` state converted by `bridge`, both
envs take the same actions for 8 steps, and the port is re-synced from the
JAX state before every step, so each step is compared from identical
inputs.  The last step ends the episodes (progress starts 7 short of the
limit); there the port's fresh scene is the JAX one, converted.

The port predicts the evader with the TP-LSTM kernel math (`_fwd_steps_t`,
bf16 matmul operands, f32 gates).  The JAX env reaches that math through
`tp_apply_t`; the stock flax `TPNet.apply` runs its gates in bf16.  So the
JAX env here predicts through `tp_apply_t` (a test-side subclass).

Tolerances: physics, rewards and stats are f32 arithmetic on identical
inputs in another operation order (rtol 1e-4, atol 1e-5: the evader's
velocity divides each force component by its own magnitude + 1e-5, which
magnifies rounding where a component is small).  The TP prediction and the
observation parts built from it differ by bf16 rounding flips of the LSTM
operands (atol 2e-3 in metres).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.envs.hideandseek import HideAndSeek as JEnv
from mupe_tpu.envs.hideandseek import HideAndSeekCfg as JCfg
from mupe_tpu.learning.tp_net import TPNet as JTPNet
from mupe_tpu.learning.tp_net import denormalize_predictions as jdenorm
from mupe_tpu.ops.tp_lstm import TPLSTMSpec as JSpec
from mupe_tpu.ops.tp_lstm import tp_apply_t
from mupe_tpu_torch import bridge
from mupe_tpu_torch.envs.hideandseek import STAT_KEYS, HideAndSeek, HideAndSeekCfg
from mupe_tpu_torch.learning.tp_net import TPNet

torch.set_num_threads(1)
E = 8
LIMIT = 800
TP_ATOL = 2e-3


class KernelTPEnv(JEnv):
    """The JAX env predicting through `tp_apply_t` (the TP kernel's math)."""

    def _tp_predict(self, tp_params, history):
        cfg = self.cfg
        spec = JSpec(input_dim=history.shape[-1], hidden=64,
                     t_steps=history.shape[-2], out_dim=3 * cfg.future_prediction_step)
        pred = tp_apply_t(spec, tp_params, history)
        return jdenorm(pred.reshape(cfg.num_envs, cfg.future_prediction_step, 3),
                       cfg.arena_size, cfg.max_height)


def to_np(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: to_np(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: to_np(v) for k, v in obj.items()}
    return None if obj is None else np.asarray(obj)


def _close(t, j, rtol=1e-4, atol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def envs():
    jenv = KernelTPEnv(JCfg(num_envs=E, max_episode_length=LIMIT))
    tenv = HideAndSeek(HideAndSeekCfg(num_envs=E, max_episode_length=LIMIT), device="cpu")
    tp_params = JTPNet(output_dim=15).init(jax.random.PRNGKey(1), jnp.zeros((1, 10, 16)))
    tnet = TPNet(16, 15, leaves=bridge.tp_leaves(jax.device_get(tp_params)))
    jstep = jax.jit(jenv.step)
    return jenv, tenv, tp_params, tnet, jstep


def test_teacher_forced_steps_match_jax(envs):
    jenv, tenv, tp_params, tnet, jstep = envs
    state = jenv.reset(jax.random.PRNGKey(0))
    state = state.replace(progress=jnp.full((E,), LIMIT - 7, jnp.int32))
    rng = np.random.default_rng(0)
    for t in range(8):
        action = rng.normal(0, 1, (E, 3, 4)).astype(np.float32)
        key = jax.random.PRNGKey(100 + t)
        new, tr = jstep(state, jnp.asarray(action), key, tp_params)
        done = bool(np.asarray(tr.done).any())
        port_env = tenv
        if done:
            # the port resets to the scene the JAX env drew
            fresh = jenv._fresh(jax.random.split(key)[0], new.v_prey, new.update_epoch)
            port_fresh = bridge.env_state(to_np(fresh))
            port_env = HideAndSeek(tenv.cfg, device="cpu")
            port_env._fresh = lambda gen, v_prey, update_epoch: port_fresh
        tnew, ttr = port_env.step(bridge.env_state(to_np(state)), torch.as_tensor(action),
                                  torch.Generator().manual_seed(t), tnet)
        assert done == (t == 6)
        _close(ttr.reward, tr.reward, what="reward")
        np.testing.assert_array_equal(ttr.done.numpy(), np.asarray(tr.done))
        assert set(ttr.stats) == set(STAT_KEYS) == set(tr.stats)
        for k in STAT_KEYS:
            _close(ttr.stats[k], tr.stats[k], atol=1e-4, what=f"stats[{k}]")
        for k in ("state_self", "state_others", "cylinders"):
            _close(ttr.obs[k], tr.obs[k], atol=TP_ATOL, what=f"obs[{k}]")
        for k in ("tp_input", "tp_gt", "tp_done", "ctbr", "drone_state"):
            _close(ttr.info[k], tr.info[k], what=f"info[{k}]")
        _close(ttr.info["tp_pred"], tr.info["tp_pred"], atol=TP_ATOL, what="tp_pred")
        jn = to_np(new)
        for f in ("pos", "quat", "vel", "angvel", "throttle"):
            _close(getattr(tnew.drone, f), jn["drone"][f], what=f"drone.{f}")
        for f in ("target_pos", "target_vel", "cylinders", "progress", "v_prey", "history",
                  "prev_action"):
            _close(getattr(tnew, f), jn[f], what=f)
        _close(tnew.pid.integ, jn["pid"]["integ"], atol=1e-4, what="pid.integ")
        state = new
    assert int(np.asarray(state.progress).max()) == 1  # reset, then one more step


def test_auto_reset_selects_injected_fresh_state(envs):
    jenv, tenv, _, _, _ = envs
    mid = jenv.reset(jax.random.PRNGKey(3))
    mid = mid.replace(progress=jnp.arange(E, dtype=jnp.int32) + 5)
    st = {k: jnp.full((E, 1), 7.0) for k in mid.stats}
    done = jnp.asarray([True, False] * (E // 2))
    key = jax.random.PRNGKey(4)
    j = jenv._auto_reset(mid, st, done, key)
    fresh = jenv._fresh(jax.random.split(key)[0], mid.v_prey, mid.update_epoch)
    t = tenv._auto_reset(
        bridge.env_state(to_np(mid)), bridge.tensors(to_np(st)),
        torch.as_tensor(np.array(done)), fresh=bridge.env_state(to_np(fresh)))
    jn = to_np(j)
    for f in ("pos", "quat", "vel", "angvel", "throttle"):
        np.testing.assert_array_equal(getattr(t.drone, f).numpy(), jn["drone"][f])
    for f in ("target_pos", "target_vel", "cylinders", "progress", "history", "prev_action",
              "tp_pred"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), jn[f])
    for k in jn["stats"]:
        np.testing.assert_array_equal(t.stats[k].numpy(), jn["stats"][k])
    assert (t.progress.numpy()[::2] == 0).all() and (t.progress.numpy()[1::2] > 0).all()


def test_reset_and_observation_shapes():
    env = HideAndSeek(HideAndSeekCfg(num_envs=4), device="cpu")
    s = env.reset(torch.Generator().manual_seed(0))
    net = TPNet(env.cfg.tp_input_dim, 15, generator=torch.Generator().manual_seed(1))
    obs, critic_state = env.observe_full(s, net)
    assert {k: tuple(v.shape) for k, v in obs.items()} == {
        "state_self": (4, 3, 1, 35), "state_others": (4, 3, 2, 3), "cylinders": (4, 3, 3, 5)}
    assert tuple(critic_state["state_drones"].shape) == (4, 3, 35)
    assert tuple(s.history.shape) == (4, 10, 16)
    assert (s.history == s.history[:, :1]).all()  # primed with the first frame


@pytest.mark.parametrize("field", ["use_random_cylinder", "use_eval", "use_cl_spawn",
                                   "eval_spawn_ratio", "eval_scenario_ratio"])
def test_deferred_config_paths_raise(field):
    value = {"use_random_cylinder": False, "eval_spawn_ratio": 0.2,
             "eval_scenario_ratio": 0.2}.get(field, True)
    with pytest.raises(NotImplementedError):
        HideAndSeek(dataclasses.replace(HideAndSeekCfg(num_envs=2), **{field: value}),
                    device="cpu")


def test_configs_match_jax():
    """Same fields and defaults as the JAX configs (MAPPOCfg without its
    TPU launch knobs, with `direct_mode`, the port's counterpart of the JAX
    package's MUPE_DIRECT_MODE environment variable), and the same stat keys."""
    from mupe_tpu.envs.hideandseek import STAT_KEYS as JSTAT_KEYS
    from mupe_tpu.learning.mappo import MAPPOCfg as JMCfg
    from mupe_tpu_torch.learning.mappo import MAPPOCfg

    def fields(c):
        return {f.name: f.default for f in dataclasses.fields(c)}

    assert fields(HideAndSeekCfg) == fields(JCfg)
    knobs = {"use_fused_encoder", "use_fused_act", "pack_rollout"}
    jm = fields(JMCfg)
    assert fields(MAPPOCfg) == {**{k: v for k, v in jm.items() if k not in knobs},
                                "direct_mode": "fwdloss"}
    assert knobs <= set(jm)
    assert STAT_KEYS == JSTAT_KEYS
