"""Position / velocity / attitude action adapters over the Lee controllers
(counterpart of mupe_tpu/transforms/lee_adapters.py): the reference's
`PosController`, `VelController` and `AttitudeController` transforms.  Each
maps a high-level policy action to rotor commands through its controller;
all stateless."""
from __future__ import annotations

import math

import torch

from ..controllers import MixerParams, attitude_control, lee_position_control
from ..dynamics import DroneState


def pos_controller_transform(mixer: MixerParams, drone: DroneState,
                             action: torch.Tensor) -> torch.Tensor:
    """7-d action [Δpos (3), vel (3), yaw (1)] → rotor commands; the
    position target is relative to the current position."""
    cmds = lee_position_control(
        mixer, drone.pos, drone.quat, drone.vel, drone.angvel,
        target_pos=drone.pos + action[..., 0:3], target_vel=action[..., 3:6],
        target_yaw=action[..., 6:7] * math.pi)
    return torch.nan_to_num(cmds, nan=0.0)


def vel_controller_transform(mixer: MixerParams, drone: DroneState,
                             action: torch.Tensor) -> torch.Tensor:
    """4-d action [vel (3), yaw (1)] → rotor commands."""
    cmds = lee_position_control(
        mixer, drone.pos, drone.quat, drone.vel, drone.angvel,
        target_pos=drone.pos, target_vel=action[..., 0:3],
        target_yaw=action[..., 3:4] * math.pi)
    return torch.nan_to_num(cmds, nan=0.0)


def attitude_controller_transform(mixer: MixerParams, drone: DroneState,
                                  action: torch.Tensor) -> torch.Tensor:
    """4-d action [thrust, yaw_rate, roll, pitch] → rotor commands."""
    target_thrust = (torch.clamp((action[..., 0:1] + 1.0) * 0.5, min=0.0)
                     * torch.sum(mixer.max_thrusts))
    cmds = attitude_control(
        mixer, drone.quat, drone.angvel, target_thrust=target_thrust,
        target_yaw_rate=action[..., 1:2] * math.pi, target_roll=action[..., 2:3] * math.pi,
        target_pitch=action[..., 3:4] * math.pi)
    return torch.nan_to_num(cmds, nan=0.0)
