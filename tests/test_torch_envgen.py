"""The AEG env (HideAndSeekEnvgen) of the port against the JAX package.

`reset` and one `step` that closes an AEG cycle, from the same converted
state, with the JAX package's draws handed to the port: the fresh state,
the uniform tasks and the buffer ("nearby") tasks.  The cycle closes on the
FPS path (the kept tasks overflow the buffer) and on the pack path.  The
JAX env predicts through the TP kernel's math (`KernelTPEnv`, see
test_torch_hideandseek.py), and the tolerances are that file's: physics,
rewards and stats rtol 1e-4 / atol 1e-5 (stats atol 1e-4), TP-derived
values atol 2e-3; the AEG buffer's counts exact and its tasks to 1e-6.

Also: the easy-case generator equals JAX's for the same seed, the
starvation fallback, and a tiny `make_train_iter` that closes cycles on the
FPS path.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.envs import genbuffer as jgb
from mupe_tpu.envs.hideandseek_envgen import HideAndSeekEnvgen as JEnvgen
from mupe_tpu.envs.hideandseek_envgen import HideAndSeekEnvgenCfg as JCfg
from mupe_tpu.learning.tp_net import TPNet as JTPNet
from mupe_tpu_torch import bridge
from mupe_tpu_torch.envs import genbuffer as tgb
from mupe_tpu_torch.envs.hideandseek_envgen import (
    HideAndSeekEnvgen,
    HideAndSeekEnvgenCfg,
    envgen_extra_stats,
)
from mupe_tpu_torch.learning import MAPPOCfg, MAPPOPolicy, init_carry, make_train_iter
from mupe_tpu_torch.learning.tp_net import TPNet
from mupe_tpu_torch.ops.fps import reference_fps
from test_torch_hideandseek import TP_ATOL, KernelTPEnv, _close, to_np

torch.set_num_threads(1)
E, LIMIT, CAP = 8, 16, 8
CFG = dict(num_envs=E, max_episode_length=LIMIT, buffer_length=CAP, use_init_easy_cases=True)
GB_FIELDS = ("history_len", "weight_count", "update_iter", "dry_cycles")


class KernelTPEnvgen(JEnvgen):
    _tp_predict = KernelTPEnv._tp_predict


@pytest.fixture(scope="module")
def envs():
    jenv = KernelTPEnvgen(JCfg(**CFG))
    tenv = HideAndSeekEnvgen(HideAndSeekEnvgenCfg(**CFG), device="cpu")
    tp_params = JTPNet(output_dim=15).init(jax.random.PRNGKey(1), jnp.zeros((1, 10, 16)))
    tnet = TPNet(16, 15, leaves=bridge.tp_leaves(jax.device_get(tp_params)))
    jits = dict(reset=jax.jit(jenv.reset), step=jax.jit(jenv.step), fresh=jax.jit(jenv._fresh),
                unif=jax.jit(jenv._uniform_tasks))
    return jenv, tenv, tp_params, tnet, jits


def _gen_close(tgen, jgen):
    for f in GB_FIELDS:
        assert int(getattr(tgen, f)) == int(getattr(jgen, f)), f
    for f in ("history", "eval_tasks", "weight_sum", "ratio_unif"):
        _close(getattr(tgen, f), getattr(jgen, f), rtol=0, atol=1e-6, what=f"gen.{f}")


def test_reset_matches_jax(envs):
    jenv, tenv, _, _, jits = envs
    key = jax.random.PRNGKey(0)
    jstate = jits["reset"](key)
    k_tasks, k_state = jax.random.split(key)
    fresh = jits["fresh"](k_state, jenv.cfg.v_prey * jenv.cfg.v_drone, 0.0)
    tasks = jits["unif"](k_tasks)
    tstate = tenv.reset(torch.Generator().manual_seed(0), fresh=bridge.env_state(to_np(fresh)),
                        tasks=torch.as_tensor(np.array(tasks)))
    jn = to_np(jstate)
    _gen_close(tstate.gen, jstate.gen)
    assert int(tstate.gen.history_len) == CAP  # the easy-case bootstrap
    for f in ("target_pos", "cylinders", "history", "progress", "v_prey"):
        _close(getattr(tstate, f), jn[f], what=f)
    _close(tstate.drone.pos, jn["drone"]["pos"], what="drone.pos")
    assert set(tstate.stats) == set(jn["stats"])
    for k, v in jn["stats"].items():
        _close(tstate.stats[k], v, what=f"stats[{k}]")


def _boundary_state(jenv, reset, path):
    """A JAX state one step before an episode end that closes a cycle: two
    eval episodes accumulated, success drawn per env; the buffer full (FPS
    path) or nearly empty (pack path)."""
    rng = np.random.default_rng({"fps": 1, "pack": 2}[path])
    state = reset(jax.random.PRNGKey(3))
    gen = state.gen.replace(
        history=jnp.asarray(rng.normal(0.0, 0.4, (CAP, jenv.cfg.task_dim)).astype(np.float32)),
        history_len=jnp.asarray(CAP if path == "fps" else 2, jnp.int32),
        weight_sum=jnp.asarray(rng.integers(0, 3, E).astype(np.float32)),
        weight_count=jnp.asarray(2, jnp.int32),
        update_iter=jnp.asarray(jenv.cfg.eval_iter - 1, jnp.int32),
    )
    stats = dict(state.stats)
    stats["success"] = jnp.asarray((rng.random((E, 1)) < 0.5).astype(np.float32))
    return state.replace(gen=gen, stats=stats,
                         progress=jnp.full((E,), LIMIT - 1, jnp.int32))


@pytest.mark.parametrize("path", ["fps", "pack"])
def test_step_closing_a_cycle_matches_jax(envs, path, monkeypatch):
    jenv, tenv, tp_params, tnet, jits = envs
    cfg = jenv.cfg
    state = _boundary_state(jenv, jits["reset"], path)
    action = np.random.default_rng(4).normal(0, 1, (E, 3, 4)).astype(np.float32)
    key = jax.random.PRNGKey(100)
    new, tr = jits["step"](state, jnp.asarray(action), key, tp_params)
    assert bool(np.asarray(tr.done).all())
    # JAX's draws inside `_auto_reset`
    fresh = jits["fresh"](jax.random.split(key)[0], new.v_prey, new.update_epoch)
    k_unif, k_nearby, _ = jax.random.split(jax.random.fold_in(key, 1), 3)
    unif = jits["unif"](k_unif)
    nearby = jgb.sample_nearby(k_nearby, new.gen, E, jenv.grid, cfg.num_agents,
                               cfg.num_cylinders, cfg.expand_step, cfg.expand_cylinders,
                               cfg.arena_size, cfg.max_height)
    fps_calls = []
    monkeypatch.setattr(tgb, "farthest_point_sampling",
                        lambda *a, **k: fps_calls.append(1) or reference_fps(*a, **k))
    port = HideAndSeekEnvgen(tenv.cfg, device="cpu")
    port._auto_reset = functools.partial(
        HideAndSeekEnvgen._auto_reset, port, fresh=bridge.env_state(to_np(fresh)),
        unif=torch.as_tensor(np.array(unif)), nearby=torch.as_tensor(np.array(nearby)))
    tnew, ttr = port.step(bridge.env_state(to_np(state)), torch.as_tensor(action),
                          torch.Generator().manual_seed(0), tnet)
    assert len(fps_calls) == (path == "fps")

    _gen_close(tnew.gen, new.gen)
    added = float(np.asarray(new.stats["add_history"])[0, 0])
    assert added > 0 and int(tnew.gen.history_len) == min(CAP, (2 if path == "pack" else CAP)
                                                           + int(added))
    _close(ttr.reward, tr.reward, what="reward")
    assert set(ttr.stats) == set(tr.stats)
    for k in tr.stats:
        _close(ttr.stats[k], tr.stats[k], atol=1e-4, what=f"tr.stats[{k}]")
    jn = to_np(new)
    assert set(tnew.stats) == set(jn["stats"]) >= set(envgen_extra_stats(cfg.num_cylinders))
    for k, v in jn["stats"].items():
        _close(tnew.stats[k], v, atol=1e-4, what=f"stats[{k}]")
    for f in ("target_pos", "cylinders", "progress", "history", "v_prey"):
        _close(getattr(tnew, f), jn[f], what=f)
    _close(tnew.drone.pos, jn["drone"]["pos"], what="drone.pos")
    _close(tnew.tp_pred, jn["tp_pred"], atol=TP_ATOL, what="tp_pred")
    for k in ("state_self", "state_others", "cylinders"):
        _close(ttr.obs[k], tr.obs[k], atol=TP_ATOL, what=f"obs[{k}]")


def test_easy_tasks_match_jax_for_the_same_seed():
    from mupe_tpu.native import generate_easy_tasks as jgen
    from mupe_tpu_torch.native import generate_easy_tasks as tgen

    for seed in (0, 7):
        np.testing.assert_array_equal(tgen(500, 9, 3, seed), jgen(500, 9, 3, seed))


def test_starvation_fallback_raises_the_uniform_mix():
    """With nothing kept (r_min above every success), `starve_cycles` = 1
    dry cycle lifts the effective uniform mix to `starve_ratio_unif`: every
    task of the new set is uniform; a cycle that keeps tasks ends it."""
    cfg = HideAndSeekEnvgenCfg(**CFG, starve_cycles=1, starve_ratio_unif=1.0, r_min=0.95)
    env = HideAndSeekEnvgen(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = env.reset(gen)
    st = dict(state.stats)
    st["success"] = torch.zeros((E, 1))
    state.gen.update_iter = torch.tensor(cfg.eval_iter - 1, dtype=torch.int32)
    done = torch.ones(E, dtype=torch.bool)
    unif = torch.full((E, cfg.task_dim), 0.25)
    nearby = torch.full((E, cfg.task_dim), -0.25)
    out = env._auto_reset(state, st, done, gen, unif=unif, nearby=nearby)
    assert int(out.gen.dry_cycles) == 1 and float(out.stats["ratio_unif"][0]) == 1.0
    assert float(out.stats["add_history"][0]) == 0.0
    assert torch.equal(out.gen.eval_tasks, unif)
    # without the fallback, 70% of the set would come from the buffer
    plain = HideAndSeekEnvgen(dataclasses.replace(cfg, starve_cycles=0), device="cpu")
    out0 = plain._auto_reset(state, st, done, gen, unif=unif, nearby=nearby)
    assert int((out0.gen.eval_tasks == nearby).all(-1).sum()) == int(E * (1 - cfg.ratio_unif))
    # a cycle that keeps tasks ends the starvation
    out.gen.update_iter = torch.tensor(cfg.eval_iter - 1, dtype=torch.int32)
    st["success"] = torch.ones((E, 1))
    keeps = HideAndSeekEnvgen(dataclasses.replace(cfg, r_min=0.5, r_max=1.0), device="cpu")
    out2 = keeps._auto_reset(out, st, done, gen, unif=unif, nearby=nearby)
    assert int(out2.gen.dry_cycles) == 0 and float(out2.stats["add_history"][0]) > 0


def test_train_iter_takes_the_fps_path(monkeypatch):
    """A tiny `make_train_iter`: 4-step episodes, 16 steps an iteration,
    cycles of 3 episodes, the buffer (8) full from the easy cases and every
    task kept (r_min = 0): each closed cycle downsamples by FPS."""
    calls = []

    def counting(*a, **k):
        calls.append(a[0].shape)
        return reference_fps(*a, **k)

    monkeypatch.setattr(tgb, "farthest_point_sampling", counting)
    cfg = HideAndSeekEnvgenCfg(num_envs=E, max_episode_length=4, buffer_length=CAP,
                               use_init_easy_cases=True, r_min=0.0)
    env = HideAndSeekEnvgen(cfg, device="cpu")
    pol = MAPPOPolicy(MAPPOCfg(train_every=16, num_minibatches=2, ppo_epochs=1, use_tp_net=True),
                      n_agents=3, action_dim=4, obs_is_dict=True, tp_input_dim=16, device="cpu")
    carry = init_carry(env, pol, torch.Generator().manual_seed(0))
    train_iter = make_train_iter(env, pol)
    for _ in range(2):
        carry, metrics, ep_stats = train_iter(carry)
    # 8 episodes: cycles close at episodes 3 and 6
    assert calls == [(CAP + E, cfg.task_dim)] * 2
    assert int(carry.env_state.gen.history_len) == CAP
    assert int(carry.env_state.gen.update_iter) == 2
    assert set(envgen_extra_stats(cfg.num_cylinders)) <= set(ep_stats)
    assert all(bool(torch.isfinite(v).all()) for v in [*metrics.values(), *ep_stats.values()])


def test_config_registry_and_stat_keys_match_jax():
    from mupe_tpu.envs import ENV_REGISTRY as JREG
    from mupe_tpu.envs.hideandseek_envgen import envgen_extra_stats as jextra
    from mupe_tpu_torch.envs import ENV_REGISTRY, HideAndSeek

    def fields(c):
        return {f.name: f.default for f in dataclasses.fields(c)}

    assert fields(HideAndSeekEnvgenCfg) == fields(JCfg)
    assert HideAndSeekEnvgenCfg().task_dim == JCfg().task_dim == 27
    assert envgen_extra_stats(5) == jextra(5)
    assert ENV_REGISTRY["HideAndSeek_envgen"] is ENV_REGISTRY["hideandseek_envgen"] \
        is HideAndSeekEnvgen
    assert ENV_REGISTRY["HideAndSeek"] is HideAndSeek
    assert HideAndSeekEnvgen.cfg_cls is HideAndSeekEnvgenCfg and HideAndSeek.cfg_cls.__name__ \
        == "HideAndSeekCfg"
    assert {"HideAndSeek", "HideAndSeek_envgen"} <= set(JREG)
