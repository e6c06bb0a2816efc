"""Crazyflie-firmware-style body-rate PID controller
(counterpart of mupe_tpu/controllers/pid_rate.py).

A per-axis PID on body rates in *degrees/s*, PWM-style mixing onto 4 motors,
and integrator state carried in an explicit `PIDRateState`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..core import const, quat_rotate_inverse

PID_KP = (250.0, 250.0, 120.0)
PID_KI = (500.0, 500.0, 16.7)
PID_KD = (2.5, 2.5, 0.0)
PID_KFF = (0.0, 0.0, 0.0)
I_LIMIT = (33.3, 33.3, 166.7)
OUT_LIMIT = 2.0**15 - 1.0


@dataclasses.dataclass
class PIDRateState:
    integ: torch.Tensor           # (..., 3) accumulated rate error [deg]
    last_body_rate: torch.Tensor  # (..., 3) previous body rate [deg/s]

    @classmethod
    def zeros(cls, batch_shape, device=None, dtype=torch.float32) -> "PIDRateState":
        shape = tuple(batch_shape) + (3,)
        return cls(
            integ=torch.zeros(shape, dtype=dtype, device=device),
            last_body_rate=torch.zeros(shape, dtype=dtype, device=device),
        )


def pid_rate_control(
    quat: torch.Tensor,
    angvel_w: torch.Tensor,
    target_rate_deg: torch.Tensor,
    target_thrust: torch.Tensor,
    pid_state: PIDRateState,
    dt: float,
    max_thrust_ratio: float = 0.9,
) -> Tuple[torch.Tensor, torch.Tensor, PIDRateState]:
    """One PID tick → (rotor_cmds (...,4) in [-1,1], ctbr (...,4), new state).
    `target_thrust` is in PWM units [0, 2^16]."""
    # made once a device: building them per step would copy from host memory
    kp, ki, kd, kff, ilimit = (const(v, quat.device, quat.dtype)
                               for v in (PID_KP, PID_KI, PID_KD, PID_KFF, I_LIMIT))

    body_rate = quat_rotate_inverse(quat, angvel_w) * (180.0 / math.pi)
    rate_error = target_rate_deg - body_rate

    out_p = rate_error * kp
    deriv = -(body_rate - pid_state.last_body_rate) / dt
    deriv = torch.nan_to_num(deriv, nan=0.0)
    out_d = deriv * kd
    integ = torch.clamp(pid_state.integ + rate_error * dt, -ilimit, ilimit)
    out_i = integ * ki
    out_ff = target_rate_deg * kff

    output = out_p + out_d + out_i + out_ff
    output = torch.nan_to_num(output, nan=0.0)
    output = torch.clamp(output, -OUT_LIMIT, OUT_LIMIT)

    r = output[..., 0:1] / 2.0
    p = output[..., 1:2] / 2.0
    y = output[..., 2:3]

    # PWM mixing (lee_position_controller.py:539-546)
    m1 = target_thrust + r - p + y
    m2 = target_thrust + r + p - y
    m3 = target_thrust - r + p + y
    m4 = target_thrust - r - p - y
    cmds = torch.cat([m1, m2, m3, m4], dim=-1) / (2.0**16) * 2.0 - max_thrust_ratio
    cmds = torch.nan_to_num(cmds, nan=0.0)

    ctbr = torch.cat([r, p, y, target_thrust], dim=-1)
    return cmds, ctbr, PIDRateState(integ=integ, last_body_rate=body_rate)
