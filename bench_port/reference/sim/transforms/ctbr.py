"""Action adapter: policy action → rotor commands through the rate PID
(counterpart of mupe_tpu/transforms/ctbr.py)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..controllers import PIDRateState, pid_rate_control
from ..dynamics import DroneState, QuadrotorParams


class CTBRResult(NamedTuple):
    rotor_cmds: torch.Tensor    # (..., R) in [-1, 1]
    ctbr: torch.Tensor          # (..., 4) controller-frame [r, p, y, thrust]
    ctbr_action: torch.Tensor   # (..., 4) normalized [rate₃∈[-1,1], thrust∈[0,ratio]]
    action_error: torch.Tensor  # (...,)   ‖ctbr_action − prev_action‖
    pid_state: PIDRateState
    target_rate_deg: torch.Tensor


def pid_rate_transform(
    params: QuadrotorParams,
    drone: DroneState,
    action: torch.Tensor,
    prev_action: torch.Tensor,
    pid_state: PIDRateState,
    dt: float,
) -> CTBRResult:
    """tanh(action) → [body-rate setpoint, thrust] → rate PID."""
    a = torch.tanh(action)
    target_rate = a[..., :3]
    target_thrust = torch.clamp((a[..., 3:4] + 1.0) * 0.5, 0.0, params.max_thrust_ratio)
    if params.fixed_yaw:
        target_rate = torch.cat([target_rate[..., :2], torch.zeros_like(target_rate[..., 2:])], -1)

    ctbr_action = torch.cat([target_rate, target_thrust], dim=-1)
    action_error = torch.linalg.vector_norm(ctbr_action - prev_action, dim=-1)

    target_rate_deg = target_rate * 180.0 * params.target_clip
    thrust_pwm = target_thrust * (2.0**16)

    rotor_cmds, ctbr, new_pid = pid_rate_control(
        drone.quat, drone.angvel, target_rate_deg, thrust_pwm, pid_state, dt,
        max_thrust_ratio=params.max_thrust_ratio,
    )
    return CTBRResult(
        rotor_cmds=torch.nan_to_num(rotor_cmds, nan=0.0),
        ctbr=ctbr,
        ctbr_action=ctbr_action,
        action_error=action_error,
        pid_state=new_pid,
        target_rate_deg=target_rate_deg,
    )


def hover_prev_action_init(params: QuadrotorParams, throttle: torch.Tensor) -> torch.Tensor:
    """Initial `prev_action` after reset: zero rates, thrust channel =
    mean(0.5·(max_thrust_ratio + (2·throttle² − 1)))."""
    cmd_init = 2.0 * torch.square(throttle) - 1.0
    thrust = torch.mean(0.5 * (params.max_thrust_ratio + cmd_init), dim=-1, keepdim=True)
    zeros = torch.zeros(tuple(throttle.shape[:-1]) + (3,), dtype=throttle.dtype,
                        device=throttle.device)
    return torch.cat([zeros, thrust], dim=-1)
