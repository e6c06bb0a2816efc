"""gym-pybullet-drones-style DSL PID position controller
(counterpart of mupe_tpu/controllers/dsl_pid.py).

The reference Crazyflie's default controller: a cascaded position →
attitude PID with PWM mixing.  The controller state is an explicit
`DSLPIDState`; every function broadcasts over leading batch dimensions.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core import const, quaternion_to_euler, quaternion_to_rotation_matrix
from ..core.math import normalize

P_COEFF_FOR = (0.4, 0.4, 1.25)
I_COEFF_FOR = (0.05, 0.05, 0.05)
D_COEFF_FOR = (0.2, 0.2, 0.5)
P_COEFF_TOR = (70000.0, 70000.0, 60000.0)
I_COEFF_TOR = (0.0, 0.0, 500.0)
D_COEFF_TOR = (20000.0, 20000.0, 12000.0)
PWM2RPM_SCALE = 0.2685
PWM2RPM_CONST = 4070.3
MIN_PWM, MAX_PWM = 20000.0, 65535.0
KF = 3.16e-10
MAX_RPM = 21714.0
MIXER_MATRIX = (
    (-0.5, -0.5, 1.0),
    (-0.5, 0.5, -1.0),
    (0.5, 0.5, 1.0),
    (0.5, -0.5, -1.0),
)


@dataclasses.dataclass
class DSLPIDState:
    integral_pos_error: torch.Tensor  # (..., 3)
    integral_rpy_error: torch.Tensor  # (..., 3)
    last_rpy: torch.Tensor            # (..., 3)

    @classmethod
    def zeros(cls, batch_shape, device=None, dtype=torch.float32) -> "DSLPIDState":
        shape = tuple(batch_shape) + (3,)
        return cls(*(torch.zeros(shape, dtype=dtype, device=device) for _ in range(3)))


def dsl_pid_control(
    pos: torch.Tensor,
    quat: torch.Tensor,
    vel: torch.Tensor,
    target_pos: torch.Tensor,
    target_vel: torch.Tensor,
    target_yaw: torch.Tensor,
    state: DSLPIDState,
    dt: float,
    mass: float = 0.0321,
) -> Tuple[torch.Tensor, DSLPIDState]:
    """One DSL PID tick → (rotor commands in [-1, 1], the new state)."""
    dev, dtype = pos.device, pos.dtype
    rpy = quaternion_to_euler(quat)
    rot = quaternion_to_rotation_matrix(quat)
    gravity = const((0.0, 0.0, 9.81 * mass), dev, dtype)

    pos_error = target_pos - pos
    vel_error = target_vel - vel
    integral_pos_error = torch.clamp(state.integral_pos_error + pos_error * dt, -2.0, 2.0)
    target_thrust = (const(P_COEFF_FOR, dev, dtype) * pos_error
                     + const(I_COEFF_FOR, dev, dtype) * integral_pos_error
                     + const(D_COEFF_FOR, dev, dtype) * vel_error
                     + gravity)
    scalar_thrust = torch.sum(target_thrust * rot[..., :, 2], dim=-1, keepdim=True)

    target_x_c = torch.cat([torch.cos(target_yaw), torch.sin(target_yaw),
                            torch.zeros_like(target_yaw)], dim=-1)
    target_z = normalize(target_thrust)
    target_y = normalize(torch.linalg.cross(target_z, target_x_c, dim=-1))
    target_x = torch.linalg.cross(target_y, target_z, dim=-1)
    target_rot = torch.stack([target_x, target_y, target_z], dim=-1)
    err_mat = target_rot.transpose(-1, -2) @ rot - rot.transpose(-1, -2) @ target_rot
    rot_error = torch.stack([err_mat[..., 2, 1], err_mat[..., 0, 2], err_mat[..., 1, 0]], dim=-1)
    rpy_rates_error = -(rpy - state.last_rpy) / dt
    integral_rpy_error = state.integral_rpy_error - rot_error * dt
    target_torque = (-const(P_COEFF_TOR, dev, dtype) * rot_error
                     + const(D_COEFF_TOR, dev, dtype) * rpy_rates_error
                     + const(I_COEFF_TOR, dev, dtype) * integral_rpy_error)
    thrust_pwm = (torch.sqrt(torch.clamp(scalar_thrust, min=0.0) / (4.0 * KF))
                  - PWM2RPM_CONST) / PWM2RPM_SCALE
    mixer = const(MIXER_MATRIX, dev, dtype)
    pwm = torch.clamp(thrust_pwm + torch.einsum("rk,...k->...r", mixer, target_torque),
                      0.0, 65535.0)
    rpms = PWM2RPM_SCALE * pwm + PWM2RPM_CONST
    cmds = torch.square(rpms / MAX_RPM) * 2.0 - 1.0
    return cmds, DSLPIDState(integral_pos_error=integral_pos_error,
                             integral_rpy_error=integral_rpy_error, last_rpy=rpy)
