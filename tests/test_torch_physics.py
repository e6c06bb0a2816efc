"""Physics and control of the PyTorch port against the JAX package.

The same numpy inputs go through both packages on the CPU.  Both compute in
float32 with the same formulas, so single-step results agree to float32
rounding (rtol 1e-5); a 50-step trajectory accumulates rounding through the
stiff rate dynamics, so it is held to rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.controllers import PIDRateState as JPID
from mupe_tpu.core import math as jmath
from mupe_tpu.core import quat as jquat
from mupe_tpu.dynamics import DroneState as JDrone
from mupe_tpu.dynamics import RigidBodyCfg as JRigid
from mupe_tpu.dynamics import make_params as jmake_params
from mupe_tpu.dynamics import step as jstep
from mupe_tpu.envs import prey as jprey
from mupe_tpu.transforms.ctbr import hover_prev_action_init as jhover_prev
from mupe_tpu.transforms.ctbr import pid_rate_transform as jpid_transform
from mupe_tpu_torch.controllers import PIDRateState
from mupe_tpu_torch.core import math as tmath
from mupe_tpu_torch.core import quat as tquat
from mupe_tpu_torch.dynamics import DroneState, RigidBodyCfg, make_params
from mupe_tpu_torch.dynamics import step as tstep
from mupe_tpu_torch.envs import prey as tprey
from mupe_tpu_torch.transforms.ctbr import hover_prev_action_init, pid_rate_transform

torch.set_num_threads(1)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def _unit_quats(rng, shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _drone_np(rng, e, n):
    return dict(
        pos=rng.uniform(-0.5, 0.5, (e, n, 3)).astype(np.float32) + [0, 0, 0.6],
        quat=_unit_quats(rng, (e, n)),
        vel=rng.normal(0, 0.3, (e, n, 3)).astype(np.float32),
        angvel=rng.normal(0, 1.0, (e, n, 3)).astype(np.float32),
        throttle=rng.uniform(0.3, 0.9, (e, n, 4)).astype(np.float32),
    )


@pytest.mark.parametrize(
    "name", ["quat_mul", "quat_conjugate", "quat_rotate", "quat_rotate_inverse",
             "euler_to_quaternion", "quat_integrate", "quat_axis", "quat_normalize"]
)
def test_quaternion_ops_match_jax(name):
    rng = np.random.default_rng(0)
    a, b = _unit_quats(rng, (7, 3)), _unit_quats(rng, (7, 3))
    v = rng.normal(size=(7, 3, 3)).astype(np.float32)
    jf, tf = getattr(jquat, name), getattr(tquat, name)
    if name == "quat_mul":
        args = (a, b)
    elif name in ("quat_rotate", "quat_rotate_inverse"):
        args = (a, v)
    elif name in ("euler_to_quaternion", "quat_conjugate", "quat_normalize"):
        args = (v if name == "euler_to_quaternion" else 3.0 * a,)
    elif name == "quat_integrate":
        args = (a, v, 0.01)
    else:
        args = (a, 2)
    j = jf(*[jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in args])
    t = tf(*[torch.as_tensor(x) if isinstance(x, np.ndarray) else x for x in args])
    _close(t, j)


@pytest.mark.parametrize("name", ["off_diag", "cpos", "normalize"])
def test_core_math_matches_jax(name):
    rng = np.random.default_rng(5)
    p, q = rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=(5, 3)).astype(np.float32)
    args = {"off_diag": (rng.normal(size=(4, 4, 3)).astype(np.float32),),
            "cpos": (p, q), "normalize": (p,)}[name]
    _close(getattr(tmath, name)(*map(torch.as_tensor, args)),
           getattr(jmath, name)(*map(jnp.asarray, args)))


def test_pid_rate_transform_matches_jax():
    rng = np.random.default_rng(1)
    e, n = 6, 3
    d = _drone_np(rng, e, n)
    action = rng.normal(0, 1.5, (e, n, 4)).astype(np.float32)
    prev = rng.uniform(-1, 1, (e, n, 4)).astype(np.float32)
    integ = rng.normal(0, 10, (e, n, 3)).astype(np.float32)
    last = rng.normal(0, 50, (e, n, 3)).astype(np.float32)
    jr = jpid_transform(
        jmake_params("crazyflie"), JDrone(**{k: jnp.asarray(v) for k, v in d.items()}),
        jnp.asarray(action), jnp.asarray(prev),
        JPID(integ=jnp.asarray(integ), last_body_rate=jnp.asarray(last)), 0.01,
    )
    tr = pid_rate_transform(
        make_params("crazyflie"), DroneState(**{k: torch.as_tensor(v) for k, v in d.items()}),
        torch.as_tensor(action), torch.as_tensor(prev),
        PIDRateState(integ=torch.as_tensor(integ), last_body_rate=torch.as_tensor(last)), 0.01,
    )
    for field in ("rotor_cmds", "ctbr", "ctbr_action", "action_error", "target_rate_deg"):
        _close(getattr(tr, field), getattr(jr, field), rtol=1e-5, atol=1e-4)
    _close(tr.pid_state.integ, jr.pid_state.integ, atol=1e-4)
    _close(tr.pid_state.last_body_rate, jr.pid_state.last_body_rate, atol=1e-3)
    throttle = d["throttle"]
    _close(hover_prev_action_init(make_params(), torch.as_tensor(throttle)),
           jhover_prev(jmake_params(), jnp.asarray(throttle)))


def test_make_params_matches_jax_and_rejects_other_drones():
    """Every model of the zoo matches JAX's; a name outside it is refused by
    both (tests/test_torch_hover.py holds the zoo bit for bit)."""
    for model in ("crazyflie", "hummingbird", "firefly"):
        jp, tp = jmake_params(model), make_params(model)
        for f in ("mass", "inertia", "kf", "km", "directions", "tau_up", "tau_down",
                  "rotor_pos", "drag_coef"):
            _close(getattr(tp, f), getattr(jp, f))
        _close(tp.hover_throttle, jp.hover_throttle)
    for make in (make_params, jmake_params):
        with pytest.raises(KeyError):
            make("no_such_drone")


def test_dynamics_trajectory_with_downwash_matches_jax():
    rng = np.random.default_rng(2)
    e, n = 4, 3
    d = _drone_np(rng, e, n)
    # stack two drones of every arena 0.15 m apart vertically: downwash on
    d["pos"][:, 1] = d["pos"][:, 0] + [0.02, 0.0, -0.15]
    cmds = rng.uniform(-0.2, 0.6, (50, e, n, 4)).astype(np.float32)
    jp, tp = jmake_params(), make_params()
    jcfg, tcfg = JRigid(max_linear_velocity=1.0), RigidBodyCfg(max_linear_velocity=1.0)
    js = JDrone(**{k: jnp.asarray(v) for k, v in d.items()})
    ts = DroneState(**{k: torch.as_tensor(v) for k, v in d.items()})
    jit_step = jax.jit(lambda s, c: jstep(jp, s, c, 0.01, jcfg, enable_downwash=True))
    for t in range(50):
        js, jdiff = jit_step(js, jnp.asarray(cmds[t]))
        ts, tdiff = tstep(tp, ts, torch.as_tensor(cmds[t]), 0.01, tcfg, enable_downwash=True)
    for f in ("pos", "quat", "vel", "angvel", "throttle"):
        _close(getattr(ts, f), getattr(js, f), rtol=1e-4, atol=1e-5)
    _close(tdiff, jdiff, rtol=1e-4, atol=1e-6)
    assert float(np.abs(_np(ts.pos) - d["pos"]).max()) > 1e-2  # it moved


def _prey_inputs(rng, e=5, n=3, c=5):
    drone = rng.uniform(-0.6, 0.6, (e, n, 3)).astype(np.float32)
    target = rng.uniform(-0.6, 0.6, (e, 1, 3)).astype(np.float32)
    target[..., 2] = rng.uniform(0.1, 1.1, (e, 1))
    cyl = rng.uniform(-0.7, 0.7, (e, c, 3)).astype(np.float32)
    cyl[..., 2] = np.where(rng.uniform(size=(e, c)) < 0.3, -20.0, 0.6)
    return drone, target, cyl


def _prey_both(drone, target, cyl):
    args = (0.1, 0.9, 1.2, 100.0)
    jf = jprey.prey_force(jnp.asarray(drone), jnp.asarray(target), jnp.asarray(cyl), *args)
    tf = tprey.prey_force(torch.as_tensor(drone), torch.as_tensor(target),
                          torch.as_tensor(cyl), *args)
    return jf, tf


def test_prey_force_and_velocity_match_jax():
    rng = np.random.default_rng(3)
    jf, tf = _prey_both(*_prey_inputs(rng))
    _close(tf, jf, rtol=1e-5, atol=1e-4)
    for componentwise in (True, False):
        _close(tprey.prey_velocity(tf, 1.3, componentwise),
               jprey.prey_velocity(jf, 1.3, componentwise), rtol=1e-5, atol=1e-6)


def test_prey_force_denominator_guard():
    """An evader standing exactly on a cylinder wall (d − r + 1e-5 ≈ 0)
    gets a finite force, as in the JAX package."""
    drone, target, cyl = _prey_inputs(np.random.default_rng(4), e=1)
    cyl[0, 0] = [0.2, 0.1, 0.6]
    target[0, 0, :2] = cyl[0, 0, :2] + np.float32([0.1 - 1e-5, 0.0])
    jf, tf = _prey_both(drone, target, cyl)
    d_c = np.linalg.norm(target[0, 0, :2] - cyl[0, 0, :2])
    assert abs(np.float32(d_c) - np.float32(0.1) + np.float32(1e-5)) < 1e-6
    assert np.isfinite(_np(tf)).all()
    _close(tf, jf, rtol=1e-4, atol=1e-2)
    assert np.isfinite(_np(tprey.prey_velocity(tf, 1.3))).all()
