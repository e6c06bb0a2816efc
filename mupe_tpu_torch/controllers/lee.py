"""SE(3) Lee position / attitude / body-rate controllers
(counterpart of mupe_tpu/controllers/lee.py).

Stateless functions over leading batch dimensions.  The mixer maps the
desired [angular acceleration, thrust] to rotor commands through the
pseudo-inverse of the allocation matrix scaled by the inertia, computed once
on the host in float64 and cast to float32 on the caller's device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import (
    axis_angle_to_quaternion,
    const,
    quat_rotate_inverse,
    quaternion_to_euler,
    quaternion_to_rotation_matrix,
)
from ..core.math import normalize
from ..dynamics.params import DRONE_ZOO

# Lee controller gains per drone model (reference controllers/cfg/lee_controller_*.yaml)
LEE_GAINS = {
    "hummingbird": dict(
        position_gain=(4.0, 4.0, 4.0),
        velocity_gain=(2.2, 2.2, 2.2),
        attitude_gain=(0.7, 0.7, 0.035),
        angular_rate_gain=(0.1, 0.1, 0.025),
    ),
    "firefly": dict(
        position_gain=(6.0, 6.0, 6.0),
        velocity_gain=(4.7, 4.7, 4.7),
        attitude_gain=(3.0, 3.0, 0.15),
        angular_rate_gain=(0.52, 0.52, 0.18),
    ),
    "neo11": dict(
        position_gain=(8.0, 8.0, 17.0),
        velocity_gain=(6.0, 6.0, 10.0),
        attitude_gain=(4.0, 4.0, 2.0),
        angular_rate_gain=(0.7, 0.7, 0.7),
    ),
    # the reference ships no Lee gains for the crazyflie (it flies the PID
    # rate path): the hummingbird's
    "crazyflie": dict(
        position_gain=(4.0, 4.0, 4.0),
        velocity_gain=(2.2, 2.2, 2.2),
        attitude_gain=(0.7, 0.7, 0.035),
        angular_rate_gain=(0.1, 0.1, 0.025),
    ),
}


@dataclasses.dataclass
class MixerParams:
    """Controller constants on one device."""

    mixer: torch.Tensor        # (R, 4)
    max_thrusts: torch.Tensor  # (R,)
    mass: float
    inertia: torch.Tensor      # (3,)
    pos_gain: torch.Tensor
    vel_gain: torch.Tensor
    att_gain: torch.Tensor     # already divided by the inertia
    rate_gain: torch.Tensor    # already divided by the inertia


def make_mixer(model: str = "crazyflie", device: torch.device | str = "cpu") -> MixerParams:
    """The allocation mixer a.T (a a.T)^-1 diag(I, 1) of a zoo model (an
    unknown name takes the crazyflie's), in float64 on the host, then
    float32 on `device`."""
    cfg = DRONE_ZOO[model if model in DRONE_ZOO else "crazyflie"]
    r = cfg["num_rotors"]
    angles = np.asarray(cfg["rotor_angles"], dtype=np.float64)
    arm = float(cfg["arm_length"])
    fc = np.full((r,), cfg["force_constants"])
    mc = np.full((r,), cfg["moment_constants"])
    dirs = np.asarray(cfg["directions"], dtype=np.float64)
    a = np.stack([np.sin(angles) * arm, -np.cos(angles) * arm, -dirs * mc / fc,
                  np.ones_like(angles)])
    inertia = np.asarray(cfg["inertia"], dtype=np.float64)
    i4 = np.diag(np.concatenate([inertia, [1.0]]))
    mixer = a.T @ np.linalg.inv(a @ a.T) @ i4
    max_thrusts = np.full((r,), cfg["max_rotation_velocities"]) ** 2 * fc
    gains = LEE_GAINS.get(model, LEE_GAINS["crazyflie"])
    inv_i = 1.0 / inertia

    def t(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float32), device=device)

    return MixerParams(
        mixer=t(mixer), max_thrusts=t(max_thrusts), mass=float(cfg["mass"]), inertia=t(inertia),
        pos_gain=t(gains["position_gain"]), vel_gain=t(gains["velocity_gain"]),
        att_gain=t(np.asarray(gains["attitude_gain"]) * inv_i),
        rate_gain=t(np.asarray(gains["angular_rate_gain"]) * inv_i),
    )


def _mix(mp: MixerParams, ang_acc: torch.Tensor, thrust: torch.Tensor) -> torch.Tensor:
    """[ang_acc (3), thrust (1)] → normalised rotor commands in [-1, 1]."""
    cmd = torch.cat([ang_acc, thrust], dim=-1) @ mp.mixer.T
    return (cmd / mp.max_thrusts) * 2.0 - 1.0


def _attitude_error(r_des: torch.Tensor, rmat: torch.Tensor) -> torch.Tensor:
    """0.5 (R_des^T R - R^T R_des)."""
    return 0.5 * (r_des.transpose(-1, -2) @ rmat - rmat.transpose(-1, -2) @ r_des)


def lee_position_control(
    mp: MixerParams,
    pos: torch.Tensor,
    quat: torch.Tensor,
    vel: torch.Tensor,
    angvel_w: torch.Tensor,
    target_pos: torch.Tensor,
    target_vel: Optional[torch.Tensor] = None,
    target_acc: Optional[torch.Tensor] = None,
    target_yaw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Geometric SE(3) position control → rotor commands; the targets
    default to rest and the current yaw."""
    ang_vel = quat_rotate_inverse(quat, angvel_w)
    if target_vel is None:
        target_vel = torch.zeros_like(vel)
    if target_acc is None:
        target_acc = torch.zeros_like(vel)
    if target_yaw is None:
        target_yaw = quaternion_to_euler(quat)[..., -1:]
    pos_error = pos - target_pos
    vel_error = vel - target_vel
    g = const((0.0, 0.0, 9.81), pos.device, pos.dtype)
    acc = pos_error * mp.pos_gain + vel_error * mp.vel_gain - g - target_acc
    rmat = quaternion_to_rotation_matrix(quat)
    b1_des = torch.cat([torch.cos(target_yaw), torch.sin(target_yaw),
                        torch.zeros_like(target_yaw)], dim=-1)
    b3_des = -normalize(acc)
    b2_des = normalize(torch.linalg.cross(b3_des, b1_des, dim=-1))
    r_des = torch.stack([torch.linalg.cross(b2_des, b3_des, dim=-1), b2_des, b3_des], dim=-1)
    err_mat = _attitude_error(r_des, rmat)
    ang_error = torch.stack([err_mat[..., 2, 1], err_mat[..., 0, 2], err_mat[..., 1, 0]], dim=-1)
    ang_acc = -ang_error * mp.att_gain - ang_vel * mp.rate_gain
    thrust = -mp.mass * torch.sum(acc * rmat[..., :, 2], dim=-1, keepdim=True)
    return _mix(mp, ang_acc, thrust)


def _axis(values, like: torch.Tensor) -> torch.Tensor:
    return const(values, like.device, like.dtype).expand(like.shape[:-1] + (3,))


def attitude_control(
    mp: MixerParams,
    quat: torch.Tensor,
    angvel_w: torch.Tensor,
    target_thrust: torch.Tensor,
    target_yaw_rate: torch.Tensor,
    target_roll: torch.Tensor,
    target_pitch: torch.Tensor,
    att_gain=(3.0, 3.0, 0.035),
    rate_gain=(0.52, 0.52, 0.025),
) -> torch.Tensor:
    """Thrust + roll / pitch / yaw-rate attitude control → rotor commands;
    the gains (the reference AttitudeController's) are divided by the
    inertia."""
    rmat = quaternion_to_rotation_matrix(quat)
    yaw = torch.atan2(rmat[..., 1, 0], rmat[..., 0, 0])[..., None]
    q_yaw = axis_angle_to_quaternion(yaw, _axis((0.0, 0.0, 1.0), yaw))
    q_roll = axis_angle_to_quaternion(target_roll, _axis((1.0, 0.0, 0.0), target_roll))
    q_pitch = axis_angle_to_quaternion(target_pitch, _axis((0.0, 1.0, 0.0), target_pitch))
    r_des = (quaternion_to_rotation_matrix(q_yaw) @ quaternion_to_rotation_matrix(q_roll)
             @ quaternion_to_rotation_matrix(q_pitch))
    err_mat = _attitude_error(r_des, rmat)
    ang_error = torch.stack([err_mat[..., 2, 1], err_mat[..., 0, 2],
                             torch.zeros_like(err_mat[..., 0, 0])], dim=-1)
    zero = torch.zeros_like(target_yaw_rate)
    rate_des = torch.cat([zero, zero, target_yaw_rate], dim=-1)
    rel = r_des.transpose(-1, -2) @ rmat
    rate_err = angvel_w - torch.einsum("...ij,...j->...i", rel, rate_des)
    inv_i = 1.0 / mp.inertia
    ang_acc = (-ang_error * const(tuple(att_gain), quat.device, quat.dtype) * inv_i
               - rate_err * const(tuple(rate_gain), quat.device, quat.dtype) * inv_i)
    return _mix(mp, ang_acc, target_thrust)


def rate_control(
    mp: MixerParams,
    quat: torch.Tensor,
    angvel_w: torch.Tensor,
    target_rate: torch.Tensor,
    target_thrust: torch.Tensor,
    gain=(0.0052, 0.0052, 0.00025),
) -> torch.Tensor:
    """Proportional body-rate control → rotor commands; `gain` (the
    crazyflie's) is divided by the inertia."""
    body_rate = quat_rotate_inverse(quat, angvel_w)
    rate_error = body_rate - target_rate
    inv_i = 1.0 / mp.inertia
    # the zero gyroscopic term keeps the reference's order of operations
    ang_acc = (-rate_error * const(tuple(gain), quat.device, quat.dtype) * inv_i
               + torch.linalg.cross(angvel_w, angvel_w, dim=-1))
    return _mix(mp, ang_acc, target_thrust)
