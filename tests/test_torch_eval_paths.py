"""HideAndSeek's evaluation and exposure paths in the PyTorch port against
the JAX package: the scenario tables, curriculum spawns, every branch of
`_sample_scene` (fixed scenarios with and without jitter, eval spawns over
random cylinders, the spawn mix, the full-scenario mix), the constructor's
checks, and the AEG's uniform tasks under mixing.

Where the JAX package draws nothing (a fixed scenario in eval mode without
jitter) the port's scene must equal JAX's exactly.  Where it draws, the
test recomputes JAX's draws from its key with the same `jax.random` calls
and injects them into the port by replacing the env's `_uniform` /
`_randint`; positions, cylinders and flags must then be equal exactly
(rotated geometry and quaternions to f32 rounding of cos / sin, atol 1e-6).
The port's own generator stream is held by the properties
tests/test_eval_exposure.py checks for JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.envs import placement as jpl
from mupe_tpu.envs import scenarios as jsc
from mupe_tpu.envs.hideandseek import HideAndSeek as JEnv
from mupe_tpu.envs.hideandseek import HideAndSeekCfg as JCfg
from mupe_tpu_torch.envs import placement as tpl
from mupe_tpu_torch.envs import scenarios as tsc
from mupe_tpu_torch.envs.hideandseek import HideAndSeek, HideAndSeekCfg
from mupe_tpu_torch.envs.hideandseek_envgen import HideAndSeekEnvgen, HideAndSeekEnvgenCfg
from mupe_tpu_torch.learning.tp_net import TPNet

torch.set_num_threads(1)
ROT_ATOL = 1e-6


def _env(**kw):
    return HideAndSeek(HideAndSeekCfg(**kw), device="cpu")


def _scene(env, seed=0):
    out = env._sample_scene(torch.Generator().manual_seed(seed))
    return [o.numpy() for o in out]


def _jscene(cfg_kw, key=0):
    return [np.asarray(o) for o in JEnv(JCfg(**cfg_kw))._sample_scene(jax.random.PRNGKey(key))]


def _inject(env, uniforms, ints=()):
    """Replace the env's draws by the given arrays, in order; returns a
    check that every one was taken."""
    u, r = [np.asarray(a) for a in uniforms], [np.asarray(a) for a in ints]

    def uniform(gen, shape, lo, hi):
        v = u.pop(0)
        assert v.shape == tuple(shape), (v.shape, shape)
        return torch.as_tensor(np.array(v))

    def randint(gen, hi, shape):
        v = r.pop(0)
        assert v.shape == tuple(shape) and v.max() < hi
        return torch.as_tensor(v.astype(np.int64))

    env._uniform, env._randint = uniform, randint
    return lambda: not u and not r


def _jax_train_draws(cfg, key):
    """JAX's draws of the training branch (spawns and rpy) from `key`."""
    e, n = cfg.num_envs, cfg.num_agents
    a = cfg.arena_size / np.sqrt(2.0)
    h2 = cfg.max_height / 2
    k_dxy, k_txy, k_dz, k_tz, k_rpy, _ = jax.random.split(key, 6)
    u = jax.random.uniform
    return dict(
        dxy=u(k_dxy, (e, n, 2), minval=jnp.asarray([0.1, -a + 0.1]),
              maxval=jnp.asarray([a - 0.1, a - 0.1])),
        txy=u(k_txy, (e, 1, 2), minval=jnp.asarray([-a + 0.1, -a + 0.1]),
              maxval=jnp.asarray([-0.1, a - 0.1])),
        dz=u(k_dz, (e, n, 1), minval=h2 - 0.1, maxval=h2 + 0.1),
        tz=u(k_tz, (e, 1, 1), minval=h2 - 0.1, maxval=h2 + 0.1),
        rpy=u(k_rpy, (e, n, 3), minval=jnp.asarray([-0.2, -0.2, 0.0]) * jnp.pi,
              maxval=jnp.asarray([0.2, 0.2, 0.2]) * jnp.pi),
    )


def _jax_mix_draws(cfg, key, n_tab, n_full):
    """JAX's mixing draws (fold_in(key, 101), six keys)."""
    e = cfg.num_envs
    km = jax.random.split(jax.random.fold_in(key, 101), 6)
    u = jax.random.uniform
    return dict(
        which=jax.random.randint(km[0], (e,), 0, n_tab),
        theta=u(km[1], (e, 1), minval=0.0, maxval=2.0 * jnp.pi),
        m=u(km[2], (e, 1, 1)),
        which2=jax.random.randint(km[3], (e,), 0, n_full),
        theta2=u(km[4], (e, 1), minval=0.0, maxval=2.0 * jnp.pi),
        m2=u(km[5], (e, 1, 1)),
    )


# ------------------------------------------------------------------ tables
@pytest.mark.parametrize("flag", jsc.EVAL_SCENARIOS)
def test_scenario_tables_match_jax(flag):
    assert tsc.EVAL_SCENARIOS == jsc.EVAL_SCENARIOS and tsc.INVALID_Z == jsc.INVALID_Z
    for c in range(4, 9):
        try:
            want = jsc.scenario_cylinders(flag, c, 0.1, 1.2)
        except ValueError:
            with pytest.raises(ValueError):
                tsc.scenario_cylinders(flag, c, 0.1, 1.2)
            continue
        got = tsc.scenario_cylinders(flag, c, 0.1, 1.2)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] and got[0].dtype == want[0].dtype
    for n in range(1, 5):
        for got, want in zip(tsc.scenario_spawns(flag, n), jsc.scenario_spawns(flag, n)):
            np.testing.assert_array_equal(got, want)
    # passage and random need 6 cylinders, the default capacity is 5
    if flag in ("passage", "random"):
        with pytest.raises(ValueError):
            tsc.scenario_cylinders(flag, 5, 0.1, 1.2)
    with pytest.raises(ValueError):
        tsc.scenario_cylinders("nope", 5, 0.1, 1.2)


# ------------------------------------------------------------------ curriculum spawns
@pytest.mark.parametrize("num_grid,cl_bound", [(9, 1), (9, 4), (9, 6), (12, 3), (13, 6)])
def test_outside_window_mask_matches_jax(num_grid, cl_bound):
    np.testing.assert_array_equal(tpl.outside_window_mask(num_grid, cl_bound).numpy(),
                                  jpl.outside_window_mask(num_grid, cl_bound))


@pytest.mark.parametrize("cl_bound,height_bound", [(1, 0.1), (2, 0.25), (4, 0.5)])
def test_sample_spawns_cl_keeps_window_cells_and_band(cl_bound, height_bound):
    grid = tpl.make_grid(0.9, 0.1)
    g, e, n = grid.num_grid, 64, 3
    occ = tpl.outside_circle_mask(g)[None].expand(e, g, g)
    drone, target = tpl.sample_spawns_cl(torch.Generator().manual_seed(cl_bound), occ, n, grid,
                                         1.2, cl_bound=cl_bound, height_bound=height_bound)
    assert drone.shape == (e, n, 3) and target.shape == (e, 1, 3)
    pos = torch.cat([drone, target], dim=1)
    cells = tpl.continuous_to_grid(pos[..., :2], grid)
    c = g // 2
    assert ((cells >= c - cl_bound) & (cells < c + cl_bound)).all()
    flat = cells[..., 0] * g + cells[..., 1]
    assert all(len(set(row.tolist())) == n + 1 for row in flat)       # distinct cells
    assert not torch.gather(occ.reshape(e, -1), 1, flat).any()        # on free cells
    lo, hi = 0.6 - height_bound * 1.2 + 0.02, 0.6 + height_bound * 1.2 - 0.02
    assert ((pos[..., 2] >= lo) & (pos[..., 2] <= hi)).all()


def test_cl_spawn_reset_and_step_run():
    env = _env(num_envs=16, use_cl_spawn=True, cl_bound=2, height_bound=0.1,
               max_episode_length=2)
    state = env.reset(torch.Generator().manual_seed(0))
    cells = tpl.continuous_to_grid(state.drone.pos[..., :2], env.grid)
    c = env.grid.num_grid // 2
    assert ((cells >= c - 2) & (cells < c + 2)).all()
    net = TPNet(env.cfg.tp_input_dim, 15, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    for _ in range(3):  # through an auto-reset
        state, tr = env.step(state, torch.zeros(16, 3, 4), gen, net)
        assert torch.isfinite(tr.reward).all()


# ------------------------------------------------------------------ _sample_scene vs JAX
@pytest.mark.parametrize("flag,max_cylinders", [("empty", 5), ("wall", 5), ("narrow_gap", 5),
                                                ("passage", 6), ("random", 6), ("wall", 8)])
def test_fixed_eval_scene_equals_jax(flag, max_cylinders):
    """A fixed scenario in eval mode without jitter draws nothing: the
    scene equals JAX's exactly, and every env is the same trial."""
    kw = dict(num_envs=8, use_random_cylinder=False, use_eval=True, scenario_flag=flag,
              max_cylinders=max_cylinders)
    env = _env(**kw)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    got = [o.numpy() for o in env._sample_scene(gen)]
    assert torch.equal(gen.get_state(), state)  # no draw
    for g, w in zip(got, _jscene(kw)):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (got[1] == np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)).all()


def test_jittered_fixed_scene_equals_jax_with_draws_injected():
    kw = dict(num_envs=16, use_random_cylinder=False, use_eval=True, scenario_flag="wall",
              max_cylinders=6, eval_jitter_xy=0.05, eval_jitter_z=0.1, eval_jitter_rpy=0.05)
    cfg, key = JCfg(**kw), jax.random.PRNGKey(3)
    e, n = cfg.num_envs, cfg.num_agents
    kj_d, kj_t = jax.random.split(jax.random.fold_in(key, 202))
    k_rpy = jax.random.split(key, 6)[4]
    j = cfg.eval_jitter_rpy * jnp.pi
    draws = [jax.random.uniform(kj_d, (e, n, 3), minval=-1.0, maxval=1.0),
             jax.random.uniform(kj_t, (e, 1, 3), minval=-1.0, maxval=1.0),
             jax.random.uniform(k_rpy, (e, n, 3), minval=-j, maxval=j)]
    env = _env(**kw)
    taken = _inject(env, draws)
    got = _scene(env)
    want = [np.asarray(o) for o in JEnv(cfg)._sample_scene(key)]
    assert taken()
    for i in (0, 2, 3, 4, 5):  # drone, target, cylinders, fallback, degraded
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[1], want[1], atol=ROT_ATOL)  # quaternions
    assert np.abs(got[0] - got[0][:1]).max() > 0  # distinct trials


def test_eval_fixed_spawns_over_random_cylinders_equal_jax_with_draws_injected():
    kw = dict(num_envs=32, use_eval=True, eval_jitter_rpy=0.1)
    cfg, key = JCfg(**kw), jax.random.PRNGKey(5)
    d = _jax_train_draws(cfg, key)
    j = cfg.eval_jitter_rpy * jnp.pi
    rpy = jax.random.uniform(jax.random.split(key, 6)[4], (32, 3, 3), minval=-j, maxval=j)
    env = _env(**kw)
    taken = _inject(env, [d["dz"], d["tz"], rpy])
    got = _scene(env)
    want = [np.asarray(o) for o in JEnv(cfg)._sample_scene(key)]
    assert taken()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], atol=ROT_ATOL)
    # the cylinders are the port's own draw: path-feasible and off the spawns
    cyl = torch.as_tensor(got[3])
    active = cyl[..., 2] > 0
    assert tpl.feasible_layout(torch.as_tensor(got[0][..., :2]), torch.as_tensor(got[2][..., :2]),
                               cyl[..., :2], active, env.grid).all()
    assert active.sum(-1).float().mean() >= env.cfg.min_cylinders - 0.5


@pytest.mark.parametrize("rotate", [False, True])
def test_full_scenario_mix_equals_jax_with_draws_injected(rotate):
    kw = dict(num_envs=32, eval_scenario_ratio=1.0, eval_mix_rotate=rotate)
    cfg, key = JCfg(**kw), jax.random.PRNGKey(7)
    d = _jax_train_draws(cfg, key)
    m = _jax_mix_draws(cfg, key, 5, 3)
    env = _env(**kw)
    uniforms = [d["dxy"], d["txy"], d["dz"], d["tz"], d["rpy"]]
    uniforms += [m["theta2"], m["m2"]] if rotate else [m["m2"]]
    taken = _inject(env, uniforms, [m["which2"]])
    got = _scene(env)
    want = [np.asarray(o) for o in JEnv(cfg)._sample_scene(key)]
    assert taken()
    for i in (0, 2, 3):
        if rotate:
            np.testing.assert_allclose(got[i], want[i], atol=ROT_ATOL)
        else:
            np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[1], want[1], atol=ROT_ATOL)
    np.testing.assert_array_equal(got[4], want[4])
    np.testing.assert_array_equal(got[5], want[5])
    # parked cylinders are rotated in xy and keep their depth
    assert (got[3][..., 2][got[3][..., 2] < 0] == tsc.INVALID_Z).all()


def test_spawn_mix_equals_jax_with_draws_injected():
    """The spawn mix draws before the cylinders (so layouts avoid the new
    spawns): spawns and attitudes equal JAX's with the draws injected."""
    kw = dict(num_envs=32, eval_spawn_ratio=0.5)
    cfg, key = JCfg(**kw), jax.random.PRNGKey(9)
    d = _jax_train_draws(cfg, key)
    m = _jax_mix_draws(cfg, key, 5, 3)
    env = _env(**kw)
    taken = _inject(env, [d["dxy"], d["txy"], d["dz"], d["tz"], m["theta"], m["m"], d["rpy"]],
                    [m["which"]])
    got = _scene(env)
    want = [np.asarray(o) for o in JEnv(cfg)._sample_scene(key)]
    assert taken()
    mixed = np.asarray(m["m"])[:, 0, 0] < 0.5
    assert 0 < mixed.sum() < 32
    np.testing.assert_array_equal(got[0][~mixed], want[0][~mixed])
    np.testing.assert_allclose(got[0], want[0], atol=ROT_ATOL)
    np.testing.assert_allclose(got[2], want[2], atol=ROT_ATOL)
    np.testing.assert_allclose(got[1], want[1], atol=ROT_ATOL)


def test_default_scene_draws_only_the_training_branch():
    """The default configuration draws through `_uniform` exactly its
    spawns and attitudes (the layout draws follow in `sample_cylinders`)."""
    cfg, key = JCfg(num_envs=8), jax.random.PRNGKey(1)
    d = _jax_train_draws(cfg, key)
    env = _env(num_envs=8)
    taken = _inject(env, [d["dxy"], d["txy"], d["dz"], d["tz"], d["rpy"]])
    got = _scene(env)
    assert taken()
    np.testing.assert_array_equal(got[0][..., :2], np.asarray(d["dxy"]))
    np.testing.assert_array_equal(got[2][..., 2:], np.asarray(d["tz"]))


# ------------------------------------------------------------------ tests/test_eval_exposure.py
def _tables(n=3):
    return (np.stack([tsc.scenario_spawns(f, n)[0] for f in tsc.EVAL_SCENARIOS]),
            np.stack([tsc.scenario_spawns(f, n)[1] for f in tsc.EVAL_SCENARIOS]))


def test_default_has_no_mixing_and_fallback_stat():
    env = _env(num_envs=64)
    state = env.reset(torch.Generator().manual_seed(0))
    assert "scene_fallback" in state.stats and not hasattr(env, "_mix_spawn_d")
    assert float(state.stats["scene_fallback"].mean()) < 0.05


def test_eval_spawn_ratio_mixes_fixed_tables():
    d, _, t, *_ = _scene(_env(num_envs=32, eval_spawn_ratio=1.0, eval_mix_rotate=False))
    tabs_d, tabs_t = _tables()
    for i in range(32):
        err_d = np.abs(tabs_d - d[i]).max(axis=(1, 2))
        err_t = np.abs(tabs_t - t[i]).max(axis=(1, 2))
        assert ((err_d < 1e-5) & (err_t < 1e-5)).any(), i


def test_eval_spawn_ratio_rotation_preserves_radii():
    d, *_ = _scene(_env(num_envs=64, eval_spawn_ratio=1.0, eval_mix_rotate=True))
    tab_radii = np.linalg.norm(_tables()[0][..., :2], axis=-1)
    radii = np.linalg.norm(d[..., :2], axis=-1)
    for i in range(64):
        assert (np.abs(tab_radii - radii[i]).max(axis=1) < 1e-5).any(), i
    assert np.allclose(d[..., 2], 0.5, atol=1e-5)  # z untouched by the yaw rotation


def test_eval_scenario_ratio_mixes_cylinders_and_spawns():
    env = _env(num_envs=64, eval_scenario_ratio=1.0, eval_mix_rotate=False)
    _, _, _, cyl, fb, _ = _scene(env)
    assert env._mix_full_scenarios == ("empty", "wall", "narrow_gap")  # JAX's order
    found = 0
    for f in env._mix_full_scenarios:
        tab, _ = tsc.scenario_cylinders(f, 5, 0.1, 1.2)
        found += int((np.abs(cyl - tab[None]).max(axis=(1, 2)) < 1e-5).sum())
    assert found == 64 and fb.max() == 0.0
    jenv = JEnv(JCfg(num_envs=4, eval_scenario_ratio=0.5))
    for name in ("_mix_spawn_d", "_mix_spawn_t", "_mix_full_d", "_mix_full_t", "_mix_full_cyl"):
        np.testing.assert_array_equal(getattr(env, name).numpy(), np.asarray(getattr(jenv, name)))
    big = _env(num_envs=4, eval_scenario_ratio=0.5, max_cylinders=6)
    assert big._mix_full_scenarios == JEnv(
        JCfg(num_envs=4, eval_scenario_ratio=0.5, max_cylinders=6))._mix_full_scenarios
    assert big._mix_full_scenarios == tsc.EVAL_SCENARIOS


def test_partial_ratio_mixes_a_fraction():
    d, *_ = _scene(_env(num_envs=256, eval_spawn_ratio=0.25, eval_mix_rotate=False))
    tabs_d = _tables()[0]
    mixed = sum(int((np.abs(tabs_d - d[i]).max(axis=(1, 2)) < 1e-5).any()) for i in range(256))
    assert 0.10 * 256 < mixed < 0.45 * 256, mixed


def test_mixing_step_runs_and_is_finite():
    env = _env(num_envs=8, max_episode_length=8, eval_spawn_ratio=0.3, eval_scenario_ratio=0.3)
    gen = torch.Generator().manual_seed(0)
    state = env.reset(gen)
    net = TPNet(env.cfg.tp_input_dim, 15, generator=torch.Generator().manual_seed(1))
    for _ in range(9):
        action = torch.randn(8, 3, 4, generator=gen) * 0.1
        state, tr = env.step(state, action, gen, net)
        assert torch.isfinite(tr.reward).all()
    assert torch.isfinite(state.drone.pos).all()


def test_eval_mix_scenarios_restriction():
    env = _env(num_envs=32, eval_scenario_ratio=1.0, eval_mix_rotate=False,
               eval_mix_scenarios=("empty",))
    assert env._mix_full_scenarios == ("empty",)
    cyl = _scene(env)[3]
    assert cyl[..., 2].max() < 0.0  # every cylinder parked underground
    with pytest.raises(ValueError):
        _env(num_envs=4, eval_spawn_ratio=0.5, eval_mix_scenarios=("nope",))


def test_eval_jitter_produces_distinct_trials():
    base = dict(num_envs=16, use_random_cylinder=False, use_eval=True, scenario_flag="wall",
                max_cylinders=6)
    d0, q0, t0, cyl0, *_ = _scene(_env(**base))
    assert np.abs(d0 - d0[:1]).max() == 0.0 and np.abs(q0[..., 1:]).max() == 0.0
    dj, qj, tj, cylj, *_ = _scene(_env(**base, eval_jitter_xy=0.05, eval_jitter_z=0.1,
                                       eval_jitter_rpy=0.05))
    assert np.abs(dj - dj[:1]).max() > 0.0
    assert np.abs(dj - d0).max() <= 0.1 + 1e-6
    assert np.abs(dj[..., :2] - d0[..., :2]).max() <= 0.05 + 1e-6
    assert np.abs(tj - t0).max() <= 0.1 + 1e-6
    assert np.abs(qj[..., 1:]).max() > 0.0
    assert np.abs(cylj - cyl0).max() == 0.0  # the scenario's cylinders untouched


def test_eval_spawn_mix_keeps_cylinders():
    env = _env(num_envs=256, eval_spawn_ratio=1.0, eval_mix_rotate=True, max_cylinders=6)
    _, _, _, cyl, fb, _ = _scene(env, seed=3)
    assert fb.mean() < 0.02, fb.mean()
    assert ((cyl[..., 2] > 0.0).sum(-1) >= env.cfg.min_cylinders).mean() > 0.9


@pytest.mark.parametrize("kw", [
    dict(num_agents=5, use_eval=True),
    dict(num_agents=5, use_random_cylinder=False),
    dict(num_agents=5, eval_spawn_ratio=0.2),
    dict(num_agents=5, eval_scenario_ratio=0.2),
    dict(eval_scenario_ratio=0.2, eval_mix_scenarios=("wall", "nope")),
    dict(use_random_cylinder=False, scenario_flag="passage"),  # 6 cylinders, capacity 5
    dict(use_random_cylinder=False, scenario_flag="nope"),
])
def test_constructor_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError):
        JEnv(JCfg(num_envs=2, **kw))
    with pytest.raises(ValueError):
        _env(num_envs=2, **kw)


# ------------------------------------------------------------------ the AEG
def test_envgen_uniform_tasks_carry_the_mixed_scenes():
    """The AEG draws its uniform tasks through `_sample_scene`, so with the
    full-scenario mix every uniform task is a fixed scenario instance
    (mupe_tpu/envs/hideandseek_envgen.py:128-132)."""
    cfg = HideAndSeekEnvgenCfg(num_envs=32, buffer_length=16, eval_scenario_ratio=1.0,
                               eval_mix_rotate=False)
    env = HideAndSeekEnvgen(cfg, device="cpu")
    state = env.reset(torch.Generator().manual_seed(0))
    drone, target, cyl = env._tasks_to_scene(state.gen.eval_tasks)
    tabs = {f: tsc.scenario_cylinders(f, 5, 0.1, 1.2)[0] for f in env._mix_full_scenarios}
    for i in range(32):
        hits = [f for f, tab in tabs.items() if np.abs(cyl[i].numpy() - tab).max() < 1e-6]
        assert len(hits) == 1, i
        d, t = tsc.scenario_spawns(hits[0], 3)
        np.testing.assert_array_equal(drone[i].numpy(), d)
        np.testing.assert_array_equal(target[i].numpy(), t)
    # the placed scene is the task's
    assert torch.equal(state.cylinders, cyl) and torch.equal(state.target_pos, target)
    # and JAX's AEG takes its uniform tasks the same way
    assert JEnv(JCfg(num_envs=4, eval_scenario_ratio=1.0))._mix_full_scenarios == \
        env._mix_full_scenarios
