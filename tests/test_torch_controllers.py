"""The Lee and DSL PID controllers, their action adapters and the quaternion
conversions of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs (`np.random.default_rng(seed)`) go through both
packages.  Both compute in float32 with the same formulas in the same
order, so a single call agrees to float32 rounding: every output within
1e-5 of its scale, max(1, its largest magnitude) (measured: at most 6.0e-7
of it).  `make_mixer` casts the same float64 numpy results to float32 on
both sides: bit-identical.  The closed loops mirror
tests/test_controllers.py on the port's side, and the port's 700-step Lee
flight and 200-step DSL PID flight are held against JAX's: positions within
1e-4 m (measured: 1.2e-7 m and 9.4e-6 m).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu import controllers as jc
from mupe_tpu.core import math as jmath
from mupe_tpu.core import quat as jquat
from mupe_tpu.dynamics import DroneState as JDrone
from mupe_tpu.dynamics import hover_state as jhover
from mupe_tpu.dynamics import make_params as jmake_params
from mupe_tpu.dynamics import step as jstep
from mupe_tpu.transforms import lee_adapters as jad
from mupe_tpu_torch import bridge
from mupe_tpu_torch import controllers as tc
from mupe_tpu_torch.core import math as tmath
from mupe_tpu_torch.core import quat as tquat
from mupe_tpu_torch.dynamics import DRONE_ZOO, DroneState, hover_state, make_params, step
from mupe_tpu_torch.transforms import lee_adapters as tad

torch.set_num_threads(1)
DT = 0.01
REL = 1e-5        # a single call, of each output's scale
TRAJ_ATOL = 1e-4  # closed-loop positions [m]


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, dtype=np.float64)


def _held(t, j, rel=REL, scale=None):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape
    scale = max(1.0, float(np.abs(j).max())) if scale is None else scale
    err = float(np.abs(t - j).max())
    assert err <= rel * scale, (err, scale)


def _unit_quats(rng, shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _near_level_quats(rng, shape, tilt=0.3):
    rpy = rng.uniform(-tilt, tilt, shape + (3,)).astype(np.float32)
    rpy[..., 2] *= np.pi / tilt
    return np.asarray(jquat.euler_to_quaternion(jnp.asarray(rpy)))


def _drone_np(rng, e, n, rotors=4):
    return dict(
        pos=(rng.uniform(-0.5, 0.5, (e, n, 3)) + [0, 0, 1.0]).astype(np.float32),
        quat=_near_level_quats(rng, (e, n)),
        vel=rng.normal(0, 0.3, (e, n, 3)).astype(np.float32),
        angvel=rng.normal(0, 1.0, (e, n, 3)).astype(np.float32),
        throttle=rng.uniform(0.3, 0.9, (e, n, rotors)).astype(np.float32),
    )


@pytest.mark.parametrize("name", ["quaternion_to_euler", "quaternion_to_rotation_matrix",
                                  "axis_angle_to_quaternion", "symlog", "symexp"])
def test_conversions_match_jax(name):
    rng = np.random.default_rng(1)
    q = _unit_quats(rng, (64, 3))
    # pitch at and past the arcsine's clip: w y - z x = ±0.5
    q[0, 0] = [0.5, 0.5, 0.5, -0.5]
    q[0, 1] = [0.5, -0.5, -0.5, 0.5]
    if name == "axis_angle_to_quaternion":
        args = (rng.uniform(-4, 4, (64, 1)).astype(np.float32),
                rng.normal(size=(64, 3)).astype(np.float32))
        jf, tf = jquat.axis_angle_to_quaternion, tquat.axis_angle_to_quaternion
    elif name in ("symlog", "symexp"):
        args = (rng.normal(0, 3, (64, 5)).astype(np.float32),)
        jf, tf = getattr(jmath, name), getattr(tmath, name)
    else:
        args = (q,)
        jf, tf = getattr(jquat, name), getattr(tquat, name)
    _held(tf(*map(torch.as_tensor, args)), jf(*map(jnp.asarray, args)))


def test_core_exports_match_jax():
    import mupe_tpu.core as jcore
    import mupe_tpu_torch.core as tcore

    assert set(jcore.__all__) <= set(tcore.__all__)
    assert set(jc.__all__) == set(tc.__all__)


@pytest.mark.parametrize("model", sorted(DRONE_ZOO) + ["unknown"])
def test_make_mixer_matches_jax(model):
    j, t = jc.make_mixer(model), tc.make_mixer(model)
    assert t.mass == j.mass
    for k in ("mixer", "max_thrusts", "inertia", "pos_gain", "vel_gain", "att_gain",
              "rate_gain"):
        np.testing.assert_array_equal(_np(getattr(t, k)), np.asarray(getattr(j, k)), err_msg=k)
    # the bridge carries JAX's over unchanged
    b = bridge.mixer_params({k: np.asarray(v) for k, v in j._asdict().items()})
    np.testing.assert_array_equal(_np(b.mixer), np.asarray(j.mixer))


@pytest.mark.parametrize("model", ["crazyflie", "hummingbird", "firefly", "neo11"])
@pytest.mark.parametrize("targets", ["defaults", "given"])
def test_lee_position_control_matches_jax(model, targets):
    rng = np.random.default_rng(2)
    rotors = DRONE_ZOO[model]["num_rotors"]
    d = _drone_np(rng, 16, 2, rotors)
    tp = d["pos"] + rng.normal(0, 0.5, d["pos"].shape).astype(np.float32)
    kw = {}
    if targets == "given":
        kw = dict(target_vel=rng.normal(0, 0.5, (16, 2, 3)).astype(np.float32),
                  target_acc=rng.normal(0, 0.5, (16, 2, 3)).astype(np.float32),
                  target_yaw=rng.uniform(-3, 3, (16, 2, 1)).astype(np.float32))
    args = (d["pos"], d["quat"], d["vel"], d["angvel"], tp)
    jm, tm = jc.make_mixer(model), tc.make_mixer(model)
    j = jc.lee_position_control(jm, *map(jnp.asarray, args),
                                **{k: jnp.asarray(v) for k, v in kw.items()})
    t = tc.lee_position_control(tm, *map(torch.as_tensor, args),
                                **{k: torch.as_tensor(v) for k, v in kw.items()})
    assert t.shape == (16, 2, rotors)
    _held(t, j)


@pytest.mark.parametrize("model", ["crazyflie", "firefly"])
def test_attitude_and_rate_control_match_jax(model):
    rng = np.random.default_rng(3)
    rotors = DRONE_ZOO[model]["num_rotors"]
    d = _drone_np(rng, 16, 2, rotors)
    jm, tm = jc.make_mixer(model), tc.make_mixer(model)
    hover = float(np.asarray(jmake_params(model).gravity))
    thrust = (hover * rng.uniform(0.5, 1.5, (16, 2, 1))).astype(np.float32)
    yaw_rate, roll, pitch = (rng.uniform(-1, 1, (16, 2, 1)).astype(np.float32) for _ in range(3))
    j = jc.attitude_control(jm, *map(jnp.asarray, (d["quat"], d["angvel"], thrust, yaw_rate,
                                                    roll, pitch)))
    t = tc.attitude_control(tm, *map(torch.as_tensor, (d["quat"], d["angvel"], thrust,
                                                        yaw_rate, roll, pitch)))
    _held(t, j)
    rate = rng.normal(0, 1, (16, 2, 3)).astype(np.float32)
    j = jc.rate_control(jm, *map(jnp.asarray, (d["quat"], d["angvel"], rate, thrust)))
    t = tc.rate_control(tm, *map(torch.as_tensor, (d["quat"], d["angvel"], rate, thrust)))
    _held(t, j)


def test_dsl_pid_matches_jax_over_steps():
    """Five ticks from a random state, each tick's commands and state held."""
    rng = np.random.default_rng(4)
    d = _drone_np(rng, 32, 1)
    tp = (d["pos"] + rng.normal(0, 0.3, d["pos"].shape)).astype(np.float32)
    tv = rng.normal(0, 0.2, d["pos"].shape).astype(np.float32)
    ty = rng.uniform(-1, 1, (32, 1, 1)).astype(np.float32)
    st = {k: rng.normal(0, 0.2, (32, 1, 3)).astype(np.float32)
          for k in ("integral_pos_error", "integral_rpy_error", "last_rpy")}
    js = jc.DSLPIDState(**{k: jnp.asarray(v) for k, v in st.items()})
    ts = bridge.dsl_pid_state(st)
    args = (d["pos"], d["quat"], d["vel"], tp, tv, ty)
    for _ in range(5):
        jcmd, js = jc.dsl_pid_control(*map(jnp.asarray, args), js, DT)
        tcmd, ts = tc.dsl_pid_control(*map(torch.as_tensor, args), ts, DT)
        _held(tcmd, jcmd)
        for k in st:
            _held(getattr(ts, k), getattr(js, k))


@pytest.mark.parametrize("adapter", ["pos_controller_transform", "vel_controller_transform",
                                     "attitude_controller_transform"])
def test_adapters_match_jax(adapter):
    rng = np.random.default_rng(5)
    d = _drone_np(rng, 16, 2, 6)
    dim = {"pos_controller_transform": 7}.get(adapter, 4)
    action = rng.uniform(-1, 1, (16, 2, dim)).astype(np.float32)
    action[0, 0] = np.nan  # the adapters zero what the controller makes NaN
    jm, tm = jc.make_mixer("firefly"), tc.make_mixer("firefly")
    j = getattr(jad, adapter)(jm, JDrone(**{k: jnp.asarray(v) for k, v in d.items()}),
                              jnp.asarray(action))
    t = getattr(tad, adapter)(tm, DroneState(**{k: torch.as_tensor(v) for k, v in d.items()}),
                              torch.as_tensor(action))
    assert np.isfinite(_np(t)).all()
    _held(t, j)


# ---------------------------------------------------------------- closed loops
def test_rate_control_zero_error_gives_hover_mix():
    mp = tc.make_mixer("crazyflie")
    quat = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    cmds = tc.rate_control(mp, quat, torch.zeros(1, 3), torch.zeros(1, 3),
                           torch.full((1, 1), float(mp.max_thrusts.sum()) / 2))
    np.testing.assert_allclose(_np(cmds), 0.0, atol=1e-5)


def test_dsl_pid_commands_up_below_target():
    st = tc.DSLPIDState.zeros((1,))
    cmds, _ = tc.dsl_pid_control(
        torch.tensor([[0.0, 0.0, 0.5]]), torch.tensor([[1.0, 0.0, 0.0, 0.0]]), torch.zeros(1, 3),
        torch.tensor([[0.0, 0.0, 1.5]]), torch.zeros(1, 3), torch.zeros(1, 1), st, DT)
    level, _ = tc.dsl_pid_control(
        torch.tensor([[0.0, 0.0, 1.5]]), torch.tensor([[1.0, 0.0, 0.0, 0.0]]), torch.zeros(1, 3),
        torch.tensor([[0.0, 0.0, 1.5]]), torch.zeros(1, 3), torch.zeros(1, 1), st, DT)
    assert cmds.shape == (1, 4) and np.isfinite(_np(cmds)).all()
    assert bool((cmds > level).all())


def test_lee_closed_loop_flies_to_the_waypoint_as_jax():
    """The hummingbird flown to a waypoint for 700 steps (7 s): the port
    arrives (within 0.1 m) and its path is JAX's."""
    target = np.asarray([[[1.0, 0.5, 1.5]]], np.float32)
    jp, jm = jmake_params("hummingbird"), jc.make_mixer("hummingbird")

    def body(s, _):
        cmds = jc.lee_position_control(jm, s.pos, s.quat, s.vel, s.angvel,
                                       target_pos=jnp.asarray(target),
                                       target_yaw=jnp.zeros((1, 1, 1)))
        s, _ = jstep(jp, s, cmds, DT)
        return s, s.pos

    js = jhover(jp, jnp.asarray([[[0.0, 0.0, 1.0]]]), jnp.asarray([[[1.0, 0.0, 0.0, 0.0]]]))
    _, jpath = jax.jit(lambda s: jax.lax.scan(body, s, None, length=700))(js)
    tp, tm = make_params("hummingbird"), tc.make_mixer("hummingbird")
    s = hover_state(tp, torch.tensor([[[0.0, 0.0, 1.0]]]), torch.tensor([[[1.0, 0.0, 0.0, 0.0]]]))
    path = []
    for _ in range(700):
        cmds = tc.lee_position_control(tm, s.pos, s.quat, s.vel, s.angvel,
                                       target_pos=torch.as_tensor(target),
                                       target_yaw=torch.zeros(1, 1, 1))
        s, _ = step(tp, s, cmds, DT)
        path.append(s.pos)
    assert float(np.linalg.norm(_np(s.pos) - target)) < 0.1
    np.testing.assert_allclose(_np(torch.stack(path)), np.asarray(jpath), atol=TRAJ_ATOL)


def test_dsl_pid_closed_loop_as_jax():
    """The crazyflie under DSL PID toward a point 0.5 m away, 200 steps:
    the port's path is JAX's, finite (the JAX package's test asks no more:
    the reference's PWM gains are tuned for its own motor model)."""
    target = np.asarray([[[0.3, -0.2, 1.4]]], np.float32)
    jp = jmake_params("crazyflie")

    def body(carry, _):
        s, pid = carry
        cmds, pid = jc.dsl_pid_control(s.pos, s.quat, s.vel, jnp.asarray(target),
                                       jnp.zeros((1, 1, 3)), jnp.zeros((1, 1, 1)), pid, DT)
        s, _ = jstep(jp, s, cmds, DT)
        return (s, pid), s.pos

    js = jhover(jp, jnp.asarray([[[0.0, 0.0, 1.0]]]), jnp.asarray([[[1.0, 0.0, 0.0, 0.0]]]))
    _, jpath = jax.jit(lambda c: jax.lax.scan(body, c, None, length=200))(
        (js, jc.DSLPIDState.zeros((1, 1))))
    tp = make_params("crazyflie")
    s = hover_state(tp, torch.tensor([[[0.0, 0.0, 1.0]]]), torch.tensor([[[1.0, 0.0, 0.0, 0.0]]]))
    pid, path = tc.DSLPIDState.zeros((1, 1)), []
    for _ in range(200):
        cmds, pid = tc.dsl_pid_control(s.pos, s.quat, s.vel, torch.as_tensor(target),
                                       torch.zeros(1, 1, 3), torch.zeros(1, 1, 1), pid, DT)
        s, _ = step(tp, s, cmds, DT)
        path.append(s.pos)
    path = _np(torch.stack(path))
    assert np.isfinite(path).all()
    np.testing.assert_allclose(path, np.asarray(jpath), atol=TRAJ_ATOL)
