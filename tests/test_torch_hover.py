"""Hover, the drone zoo, domain randomization, the observation history and
the sim-free HideAndSeek of the PyTorch port against the JAX package on the
CPU (the Hover cases of tests/test_envs.py: observation layout, auto-reset,
the sim2real options, domain randomization).

`jax.random` streams cannot be reproduced in torch, so every draw of the JAX
env (initial pose, payload, randomized parameters, action and observation
noise) is recomputed from its key, with the JAX package's own sampling
functions recording their `jax.random.uniform` outputs, and injected into
the port through `Hover._uniform` / `Hover._normal`.

Tolerances, as tests/test_torch_physics.py holds the physics:

* a free-running run of 12 steps (two auto-resets) from the same state with
  the same actions and draws: observations, reward, every stat and the
  state within rtol 1e-4 / atol 1e-5 (measured up to 0.66 of that limit,
  on the realized body rates in deg/s);
* teacher-forced single steps (the port steps JAX's state, converted, each
  step): within rtol 1e-5 plus 1e-5 of the quantity's largest magnitude
  over the batch (the body rates in deg/s are rotated from the world
  frame, so a small component carries the rounding of the vector's
  magnitude);
* the thresholds `pos_error <= 0.02` and `head_error <= 0.02` gate bonuses:
  no step of these runs sits within rounding of them, and `done` and the
  bonuses must be equal;
* tables and resets: parameters of the zoo exactly equal (both round the
  same float64 numbers to float32), resets within rtol 1e-6 / atol 1e-7.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.dynamics import make_params as jmake_params
from mupe_tpu.dynamics.params import DRONE_ZOO as JZOO
from mupe_tpu.dynamics.randomization import RandomizationCfg as JRandCfg
from mupe_tpu.dynamics.randomization import intrinsics_vector as jintrinsics_vector
from mupe_tpu.dynamics.randomization import randomize_params as jrandomize_params
from mupe_tpu.envs.fake import FakeHideAndSeek as JFake
from mupe_tpu.envs.hideandseek import HideAndSeekCfg as JHSCfg
from mupe_tpu.envs.hover import STAT_KEYS as JSTAT_KEYS
from mupe_tpu.envs.hover import Hover as JHover
from mupe_tpu.envs.hover import HoverCfg as JCfg
from mupe_tpu.learning.tp_net import TPNet as JTP
from mupe_tpu.transforms.obs import history_init as jhistory_init
from mupe_tpu.transforms.obs import history_push as jhistory_push
from mupe_tpu_torch import bridge
from mupe_tpu_torch.dynamics import DRONE_ZOO, make_params
from mupe_tpu_torch.dynamics.randomization import (
    RandomizationCfg,
    intrinsics_vector,
    randomize_params,
)
from mupe_tpu_torch.envs import ENV_REGISTRY, FakeHideAndSeek, HideAndSeekCfg, Hover, HoverCfg
from mupe_tpu_torch.envs.hover import STAT_KEYS
from mupe_tpu_torch.learning.tp_net import TPNet
from mupe_tpu_torch.transforms.obs import history_init, history_push
from test_torch_hideandseek import KernelTPEnv, to_np

torch.set_num_threads(1)
E, LENGTH, STEPS = 8, 5, 12
DR_ALL = dict(dr_mass_scale=(0.8, 1.2), dr_inertia_scale=(0.7, 1.3), dr_t2w_scale=(0.8, 1.2),
              dr_f2m_scale=(0.8, 1.2), dr_drag_scale=(0.5, 1.5),
              dr_rotor_offset_scale=(-0.1, 0.1), dr_tau_up=(0.01, 0.05),
              dr_tau_down=(0.01, 0.05))
SIM2REAL = dict(obs_noise=True, latency=True, payload=True, obs_omega=True, obs_motor=True,
                action_noise=True)
CONFIGS = {
    "default": {},
    **{flag: {flag: True} for flag in SIM2REAL},
    "time_encoding": dict(time_encoding_dim=8),
    "sim2real": SIM2REAL,
    **{name: {name: rng} for name, rng in DR_ALL.items()},
    "dr_all": DR_ALL,
    "history": dict(obs_history_len=4),
    # DR with payload (the nominal parameters drive the rate controller, the
    # perturbed ones plus the payload the dynamics) and every flag
    "everything": dict(**SIM2REAL, **DR_ALL, obs_history_len=3),
}
FOUR_ROTORS = [m for m, c in JZOO.items() if c["num_rotors"] == 4]
MULTIROTORS = [m for m, c in JZOO.items() if c["num_rotors"] != 4]


# ------------------------------------------------------------------ draws
@contextlib.contextmanager
def recording():
    """Record every `jax.random.uniform` output (the JAX env's draws)."""
    log, real = [], jax.random.uniform

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        v = real(key, shape, dtype, minval, maxval)
        log.append(np.asarray(v))
        return v

    jax.random.uniform = uniform
    try:
        yield log
    finally:
        jax.random.uniform = real


def jax_reset_draws(jenv, key):
    """The uniforms of `Hover.reset(key)`, in the port's order (randomized
    parameters, pose, payload)."""
    k_init, k_payload, k_dr, _ = jax.random.split(key, 4)
    return _fresh_draws(jenv, k_init, k_payload, k_dr)


def _fresh_draws(jenv, k_init, k_payload, k_dr):
    e = jenv.cfg.num_envs
    with recording() as log:
        params, _ = jenv._sample_dr(k_dr)
        jenv._sample_drone_state(k_init, (e, 1), params)
        jenv._sample_payload(k_payload, (e, 1))
    return log


def jax_step_draws(jenv, key, reset: bool):
    """(uniforms, normals) of `Hover.step(state, action, key)` in the port's
    order: action noise, the fresh state (on a reset step), observation
    noise."""
    cfg = jenv.cfg
    e = cfg.num_envs
    k_anoise, k_onoise, k_payload, k_init, k_dr, _ = jax.random.split(key, 6)
    normals = []
    if cfg.action_noise:
        normals.append(np.asarray(jax.random.normal(k_anoise, (e, 1, 4))))
    uniforms = _fresh_draws(jenv, k_init, k_payload, k_dr) if reset else []
    if cfg.obs_noise:
        normals.append(np.asarray(jax.random.normal(k_onoise, (e, 1, cfg.obs_dim))))
    return uniforms, normals


def inject(env, uniforms=(), normals=()):
    """Replace the env's draws by the given arrays, in order; returns a check
    that every one was taken."""
    u, n = [np.asarray(a) for a in uniforms], [np.asarray(a) for a in normals]

    def uniform(gen, shape, lo, hi):
        v = u.pop(0)
        assert v.shape == tuple(shape), (v.shape, shape)
        return torch.as_tensor(np.array(v))

    def normal(gen, shape):
        v = n.pop(0)
        assert v.shape == tuple(shape), (v.shape, shape)
        return torch.as_tensor(np.array(v))

    env._uniform, env._normal = uniform, normal
    return lambda: not u and not n


# ------------------------------------------------------------------ helpers
def _envs(**kw):
    cfg = dict(num_envs=E, max_episode_length=LENGTH, **kw)
    return JHover(JCfg(**cfg)), Hover(HoverCfg(**cfg), device="cpu")


def _reset_both(jenv, tenv, seed=0):
    key = jax.random.PRNGKey(seed)
    js = jenv.reset(key)
    taken = inject(tenv, jax_reset_draws(jenv, key))
    ts = tenv.reset(torch.Generator())
    assert taken()
    return js, ts


def _obs_dict(obs):
    return obs if isinstance(obs, dict) else {"obs": obs}


def _state_leaves(state) -> dict:
    """Every tensor of an env state as {path: array}, both packages."""
    out = {}

    def walk(obj, path):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, f"{path}/{k}")
        elif dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                if f.name != "key":
                    walk(getattr(obj, f.name), f"{path}/{f.name}")
        elif obj is not None and not isinstance(obj, (bool, int, float)):
            out[path] = np.asarray(obj.detach() if isinstance(obj, torch.Tensor) else obj)

    walk(state, "")
    return out


def _hold(got: dict, want: dict, rtol, atol, scaled=False, what=""):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, w in want.items():
        g, w = (np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
                for v in (got[k], w))
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f"{what}{k}")
            continue
        a = atol * (max(1.0, float(np.abs(w).max(initial=0.0))) if scaled else 1.0)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=a, err_msg=f"{what}{k}")


def _transition(tr) -> dict:
    out = {f"obs/{k}": v for k, v in _obs_dict(tr.obs).items()}
    out.update({f"stats/{k}": v for k, v in tr.stats.items()})
    for k, v in tr.info.items():
        out.update({f"info/{k}/{kk}": vv for kk, vv in v.items()} if isinstance(v, dict)
                   else {f"info/{k}": v})
    out.update(reward=tr.reward, done=tr.done)
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def _run(jenv, tenv, teacher_forced: bool):
    """STEPS steps with the same actions and draws; yields each step's
    (port transition, JAX transition, port state, JAX state)."""
    js, ts = _reset_both(jenv, tenv)
    rng = np.random.default_rng(1)
    jstep = jax.jit(jenv.step)
    for t in range(STEPS):
        action = rng.normal(size=(E, 1, 4)).astype(np.float32)
        key = jax.random.PRNGKey(100 + t)
        if teacher_forced:
            ts = bridge.hover_state(to_np(js))
        taken = inject(tenv, *jax_step_draws(jenv, key, reset=(t + 1) % LENGTH == 0))
        js, jtr = jstep(js, jnp.asarray(action), key)
        ts, ttr = tenv.step(ts, torch.as_tensor(action), torch.Generator())
        assert taken()
        yield ttr, jtr, ts, js


# ------------------------------------------------------------------ tables
@pytest.mark.parametrize("model", sorted(JZOO))
def test_drone_zoo_matches_jax(model):
    """Every model of the zoo: the same constants, exactly."""
    assert DRONE_ZOO[model] == JZOO[model]
    jp, tp = jmake_params(model), make_params(model)
    for f in ("mass", "inertia", "kf", "km", "directions", "tau_up", "tau_down", "rotor_pos",
              "drag_coef", "hover_throttle"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)), f)
    for f in ("target_clip", "max_thrust_ratio", "fixed_yaw", "num_rotors"):
        assert getattr(tp, f) == getattr(jp, f)


def test_history_window_matches_jax():
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(3, 1, 7)).astype(np.float32)
    new = rng.normal(size=(3, 1, 7)).astype(np.float32)
    w = history_init(torch.as_tensor(obs), 4)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jhistory_init(jnp.asarray(obs), 4)))
    np.testing.assert_array_equal(
        history_push(w, torch.as_tensor(new)).numpy(),
        np.asarray(jhistory_push(jhistory_init(jnp.asarray(obs), 4), jnp.asarray(new))))


@pytest.mark.parametrize("model", ["crazyflie", "firefly"])
def test_randomize_params_matches_jax(model):
    """Every range on, for a 4- and a 6-rotor model: the randomized leaves
    and the intrinsics vector, from JAX's draws."""
    key = jax.random.PRNGKey(3)
    rand = dict(mass_scale=(0.8, 1.2), inertia_scale=(0.7, 1.3), t2w_scale=(0.8, 1.2),
                f2m_scale=(0.8, 1.2), drag_coef_scale=(0.5, 1.5),
                rotor_offset_scale=(-0.1, 0.1), tau_up=(0.01, 0.05), tau_down=(0.01, 0.05))
    with recording() as draws:
        jp, jintr = jrandomize_params(key, jmake_params(model), JRandCfg(**rand), 6)
    queue = list(draws)

    def uniform(shape, lo, hi):
        v = queue.pop(0)
        assert v.shape == tuple(shape)
        return torch.as_tensor(np.array(v))

    tp, tintr = randomize_params(uniform, make_params(model), RandomizationCfg(**rand), 6)
    assert not queue
    for f in ("mass", "inertia", "kf", "km", "tau_up", "tau_down", "rotor_pos", "drag_coef"):
        np.testing.assert_allclose(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                                   rtol=1e-6, err_msg=f)
    np.testing.assert_allclose(intrinsics_vector(tintr).numpy(),
                               np.asarray(jintrinsics_vector(jintr)), rtol=1e-6, atol=1e-7)
    assert tuple(intrinsics_vector(tintr).shape) == (6, 1, 22 + 4 * (tp.num_rotors - 4))


# ------------------------------------------------------------------ reset / observe
@pytest.mark.parametrize("model", sorted(JZOO))
def test_reset_matches_jax_for_every_drone(model):
    """Reset and the first observation for every model (the multirotors
    reset in both packages; only their step fails)."""
    jenv, tenv = _envs(drone_model=model, **DR_ALL, payload=True)
    js, ts = _reset_both(jenv, tenv)
    _hold(_state_leaves(ts), _state_leaves(js), 1e-6, 1e-7, what=f"{model} state")
    _hold(_obs_dict(tenv.observe(ts)), _obs_dict(jenv.observe(js)), 1e-6, 1e-7)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reset_and_observation_layout_match_jax(name):
    """Reset under each configuration: the state, the observation's keys and
    shapes (flat [E, 1, obs_dim], or a dict with `intrinsics` and / or
    `observation_h`), and values."""
    jenv, tenv = _envs(**CONFIGS[name])
    js, ts = _reset_both(jenv, tenv)
    assert tenv.cfg.obs_dim == jenv.cfg.obs_dim
    assert tenv.cfg.obs_is_dict == jenv.cfg.obs_is_dict
    tobs, jobs = _obs_dict(tenv.observe(ts)), _obs_dict(jenv.observe(js))
    assert {k: tuple(v.shape) for k, v in tobs.items()} == {
        k: tuple(v.shape) for k, v in jobs.items()}
    _hold(tobs, {k: np.asarray(v) for k, v in jobs.items()}, 1e-6, 1e-7)
    _hold(_state_leaves(ts), _state_leaves(js), 1e-6, 1e-7, what=f"{name} state")


# ------------------------------------------------------------------ step
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_free_running_steps_match_jax(name):
    """12 steps with two auto-resets: every transition and the final state
    within rtol 1e-4 / atol 1e-5; done and the episode structure exact."""
    jenv, tenv = _envs(**CONFIGS[name])
    for t, (ttr, jtr, ts, js) in enumerate(_run(jenv, tenv, teacher_forced=False)):
        got, want = _transition(ttr), _transition(jtr)
        np.testing.assert_array_equal(got["done"], want["done"])
        assert bool(got["done"].all()) == ((t + 1) % LENGTH == 0)
        _hold(got, want, 1e-4, 1e-5, scaled=True, what=f"step {t} ")
    _hold(_state_leaves(ts), _state_leaves(js), 1e-4, 1e-5, scaled=True, what="final state")
    assert set(ttr.stats) == set(STAT_KEYS) == set(JSTAT_KEYS)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_teacher_forced_steps_match_jax(name):
    """Each step from JAX's state: within rtol 1e-5 + 1e-5 of the
    quantity's scale."""
    jenv, tenv = _envs(**CONFIGS[name])
    for t, (ttr, jtr, ts, js) in enumerate(_run(jenv, tenv, teacher_forced=True)):
        got, want = _transition(ttr), _transition(jtr)
        np.testing.assert_array_equal(got["stats/pos_bonus"], want["stats/pos_bonus"])
        _hold(got, want, 1e-5, 1e-6, scaled=True, what=f"step {t} ")
        _hold(_state_leaves(ts), _state_leaves(js), 1e-5, 1e-6, scaled=True,
              what=f"step {t} state")


@pytest.mark.parametrize("model", FOUR_ROTORS)
def test_every_steppable_drone_matches_jax(model):
    """The 4-rotor models under every flag and range, free-running."""
    jenv, tenv = _envs(drone_model=model, **CONFIGS["everything"])
    for t, (ttr, jtr, ts, js) in enumerate(_run(jenv, tenv, teacher_forced=False)):
        _hold(_transition(ttr), _transition(jtr), 1e-4, 1e-5, scaled=True,
              what=f"{model} step {t} ")


@pytest.mark.parametrize("model", MULTIROTORS)
def test_multirotor_step_fails_as_in_jax(model):
    """The rate controller mixes onto 4 motors: JAX's step fails on a 6- or
    12-rotor model, and so does the port's, naming the rotor count."""
    jenv, tenv = _envs(drone_model=model)
    js, ts = _reset_both(jenv, tenv)
    with pytest.raises(TypeError):
        jenv.step(js, jnp.zeros((E, 1, 4)), jax.random.PRNGKey(1))
    with pytest.raises(TypeError, match=f"{JZOO[model]['num_rotors']} rotors"):
        tenv.step(ts, torch.zeros((E, 1, 4)), torch.Generator())


def test_dr_and_payload_use_the_nominal_controller_and_perturbed_dynamics():
    """With DR and payload on, a step differs from one whose dynamics take
    the nominal parameters without payload, while the rate controller's
    state is the same in both: a swap of the two parameter sets would pass
    every test run with DR off."""
    jenv, tenv = _envs(**DR_ALL, payload=True)
    _, ts = _reset_both(jenv, tenv)
    action = torch.as_tensor(np.random.default_rng(4).normal(size=(E, 1, 4)).astype(np.float32))
    moved, _ = tenv.step(ts, action, torch.Generator())
    leaves = ("mass", "inertia", "kf", "km", "tau_up", "tau_down", "rotor_pos", "drag_coef")
    nominal = dataclasses.replace(
        ts, payload_mass=torch.zeros_like(ts.payload_mass),
        dyn_params=dataclasses.replace(ts.dyn_params, **{
            f: getattr(tenv.params, f).expand_as(getattr(ts.dyn_params, f)) for f in leaves}))
    other, _ = tenv.step(nominal, action, torch.Generator())
    assert float((moved.drone.vel - other.drone.vel).abs().max()) > 1e-4
    np.testing.assert_array_equal(moved.pid.integ.numpy(), other.pid.integ.numpy())
    np.testing.assert_array_equal(moved.prev_action.numpy(), other.prev_action.numpy())


def test_cli_ranges_parse_as_in_jax():
    """`env.dr_mass_scale='[0.8,1.2]'` (an Optional tuple field) and the
    payload range parse to the same configuration as the JAX package's."""
    from mupe_tpu.utils.config import apply_overrides as japply
    from mupe_tpu_torch.utils.config import apply_overrides

    over = {"dr_mass_scale": "[0.8,1.2]", "payload_mass_range": "[0.02,0.2]",
            "obs_history_len": "3", "latency": "true"}
    got, want = apply_overrides(HoverCfg(), over), japply(JCfg(), over)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.dr_mass_scale == (0.8, 1.2) and got.obs_is_dict


def test_obs_depth_frame_matches_jax():
    """The depth camera's frame [E, 1, 24, 32, 1] in [0, 1] (Hover's default
    size; the ground and the target sphere): exactly JAX's at reset and, on
    each teacher-forced step through an auto-reset, exactly JAX's frame of
    JAX's state after the step (its eager `observe`; no ray of these scenes
    grazes the sphere), while the port's own step emits it within the
    teacher-forced bound of the step's other quantities."""
    jenv, tenv = _envs(obs_depth=True)
    js, ts = _reset_both(jenv, tenv)
    got, want = tenv.observe(ts), jenv.observe(js)
    assert list(got) == list(want) == ["observation", "depth"]
    assert got["depth"].shape == (E, 1, 24, 32, 1)
    np.testing.assert_array_equal(got["depth"].numpy(), np.asarray(want["depth"]))
    for t, (ttr, jtr, _, js) in enumerate(_run(jenv, tenv, teacher_forced=True)):
        frame = tenv.observe(bridge.hover_state(to_np(js)))["depth"]
        np.testing.assert_array_equal(frame.numpy(), np.asarray(jenv.observe(js)["depth"]),
                                      err_msg=f"step {t}")
        d = ttr.obs["depth"].numpy()
        np.testing.assert_allclose(d, np.asarray(jtr.obs["depth"]), rtol=0, atol=1e-5,
                                   err_msg=f"step {t}")
        assert d.min() >= 0.0 and d.max() <= 1.0 and d.max() > 0.0


def test_hover_is_registered_and_defaults_to_the_card():
    assert ENV_REGISTRY["Hover"] is Hover and ENV_REGISTRY["hover"] is Hover
    assert ENV_REGISTRY["FakeHideAndSeek"] is FakeHideAndSeek
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            Hover(HoverCfg(num_envs=2))


# ------------------------------------------------------------------ the sim-free env
class KernelTPFake(JFake):
    """JAX's sim-free env predicting through `tp_apply_t` (the TP kernel's
    math, as the port's plain version)."""

    _tp_predict = KernelTPEnv._tp_predict


@pytest.mark.parametrize("use_tp_net", [False, True])
def test_fake_hideandseek_matches_jax(use_tp_net):
    """Steps without physics: positions frozen, the rate controller's
    commands, the observation (TP prediction included), progress wrapping
    at max_episode_length; obs and info within 1e-5 (the TP forward's
    rounding points, as tests/test_torch_hideandseek.py holds them)."""
    cfg = dict(num_envs=4, max_episode_length=3, use_tp_net=use_tp_net)
    jenv = KernelTPFake(JHSCfg(**cfg))
    tenv = FakeHideAndSeek(HideAndSeekCfg(**cfg), device="cpu")
    jtp = JTP(output_dim=15).init(jax.random.PRNGKey(0), jnp.zeros((1, 10, 16)))
    tp = TPNet(16, 15, leaves=bridge.tp_leaves(jax.device_get(jtp)), device="cpu")
    js = jenv.reset(jax.random.PRNGKey(2))
    ts = bridge.env_state(to_np(js))
    rng = np.random.default_rng(5)
    for t in range(4):
        a = rng.normal(size=(4, 3, 4)).astype(np.float32)
        js, jtr = jenv.step(js, jnp.asarray(a), jax.random.PRNGKey(t), jtp if use_tp_net else None)
        ts, ttr = tenv.step(ts, torch.as_tensor(a), None, tp if use_tp_net else None)
        _hold(_transition(ttr), _transition(jtr), 1e-5, 1e-5, what=f"step {t} ")
        assert int(ts.progress[0]) == (t + 1) % 3
    np.testing.assert_array_equal(ts.drone.pos.numpy(), np.asarray(js.drone.pos))


def test_fake_hideandseek_inject_matches_jax():
    jenv = JFake(JHSCfg(num_envs=2, use_tp_net=False))
    tenv = FakeHideAndSeek(HideAndSeekCfg(num_envs=2, use_tp_net=False), device="cpu")
    js = jenv.reset(jax.random.PRNGKey(0))
    ts = bridge.env_state(to_np(js))
    rng = np.random.default_rng(6)
    vals = [rng.normal(size=s).astype(np.float32)
            for s in ((2, 3, 3), (2, 3, 4), (2, 3, 3), (2, 3, 3), (2, 1, 3), (2, 1, 3))]
    js = jenv.inject(js, *[jnp.asarray(v) for v in vals])
    ts = tenv.inject(ts, *[torch.as_tensor(v) for v in vals])
    _hold(_state_leaves(ts), _state_leaves(js), 0.0, 0.0)
