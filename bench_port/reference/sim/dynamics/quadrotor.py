"""Quadrotor rigid-body dynamics (counterpart of mupe_tpu/dynamics/quadrotor.py).

    rotor cmds ∈ [-1, 1]^R → first-order rotor lag → per-rotor thrust and
    yaw moment → body wrench → downwash + linear drag → semi-implicit Euler.

Every function broadcasts over leading batch dimensions, typically
[num_envs, n_agents].
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core import quat_axis, quat_integrate, quat_rotate, quat_rotate_inverse
from .params import QuadrotorParams, RigidBodyCfg


@dataclasses.dataclass
class DroneState:
    pos: torch.Tensor       # (..., 3)  world position (env-local frame)
    quat: torch.Tensor      # (..., 4)  wxyz body→world rotation
    vel: torch.Tensor       # (..., 3)  world linear velocity
    angvel: torch.Tensor    # (..., 3)  world angular velocity
    throttle: torch.Tensor  # (..., R)  normalized rotor throttle in [0, 1]

    @property
    def heading(self) -> torch.Tensor:
        return quat_axis(self.quat, 0)

    @property
    def up(self) -> torch.Tensor:
        return quat_axis(self.quat, 2)

    @property
    def body_rate(self) -> torch.Tensor:
        """Angular velocity in the body frame [rad/s]."""
        return quat_rotate_inverse(self.quat, self.angvel)

    def state_vector(self) -> torch.Tensor:
        """[pos(3), quat(4), vel_w(3), angvel_w(3), heading(3), up(3),
        2·throttle−1(R)]."""
        return torch.cat(
            [self.pos, self.quat, self.vel, self.angvel, self.heading, self.up,
             self.throttle * 2.0 - 1.0],
            dim=-1,
        )


def hover_state(
    params: QuadrotorParams, pos: torch.Tensor, quat: torch.Tensor
) -> DroneState:
    """A zero-velocity state at hover throttle (`params` may be per-env
    randomized ones, [E, 1]-leading leaves)."""
    batch = tuple(pos.shape[:-1])
    throttle = params.hover_throttle[..., None].to(pos.dtype).expand(batch + (params.num_rotors,))
    return DroneState(
        pos=pos,
        quat=quat,
        vel=torch.zeros(batch + (3,), dtype=pos.dtype, device=pos.device),
        angvel=torch.zeros(batch + (3,), dtype=pos.dtype, device=pos.device),
        throttle=throttle.contiguous(),
    )


def rotor_response(
    params: QuadrotorParams, throttle: torch.Tensor, cmds: torch.Tensor, dt: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """First-order rotor lag and thrust/moment curves → (new_throttle,
    thrusts, moments), each (..., R)."""
    target = torch.sqrt(torch.clamp((cmds + 1.0) * 0.5, 0.0, 1.0))
    tau = torch.where(target > throttle, params.tau_up, params.tau_down)
    tau = torch.clamp(tau, 0.0, 1.0)
    alpha = dt / tau
    new_throttle = throttle + alpha * (target - throttle)
    t = torch.clamp(torch.square(new_throttle), 0.0, 1.0)
    thrusts = t * params.kf
    moments = t * params.km * (-params.directions)
    return new_throttle, thrusts, moments


def body_wrench(
    params: QuadrotorParams, thrusts: torch.Tensor, moments: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """F_b = Σ f_i ẑ,  τ_b = Σ r_i × (f_i ẑ) + Σ m_i ẑ."""
    force_z = torch.sum(thrusts, dim=-1)
    zeros = torch.zeros_like(force_z)
    force_b = torch.stack([zeros, zeros, force_z], dim=-1)
    rx = params.rotor_pos[..., 0]
    ry = params.rotor_pos[..., 1]
    tau_x = torch.sum(thrusts * ry, dim=-1)
    tau_y = torch.sum(-thrusts * rx, dim=-1)
    tau_z = torch.sum(moments, dim=-1)
    return force_b, torch.stack([tau_x, tau_y, tau_z], dim=-1)


def downwash_forces(
    pos: torch.Tensor, thrust_w: torch.Tensor, kr: float = 2.0, kz: float = 0.3
) -> torch.Tensor:
    """Pairwise downwash among the n drones of one arena: drone i receives
    from every other drone j  −T_j · exp(−0.5 (kr·r/z)²) / (1 + kz·z)²."""
    d = thrust_w / (torch.linalg.vector_norm(thrust_w, dim=-1, keepdim=True) + 1e-6)
    rel = pos[..., None, :, :] - pos[..., :, None, :]   # [..., i, j, :] = p_j − p_i
    dj = d[..., None, :, :].expand(rel.shape)
    z = torch.sum(rel * dj, dim=-1, keepdim=True)
    r_vec = rel - z * dj
    r = torch.linalg.vector_norm(r_vec, dim=-1, keepdim=True)
    z = torch.clamp(z, min=0.0)
    z_safe = torch.where(z == 0.0, torch.full_like(z, 1e-6), z)
    v = torch.exp(-0.5 * torch.square(kr * r / z_safe)) / torch.square(1.0 + kz * z)
    f = v * (-thrust_w[..., None, :, :].expand(rel.shape))
    n = pos.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)[..., None]
    f = torch.where(eye, torch.zeros_like(f), f)
    return torch.sum(f, dim=-2)


def integrate(
    params: QuadrotorParams,
    state: DroneState,
    force_w: torch.Tensor,
    torque_b: torch.Tensor,
    dt: float,
    cfg: RigidBodyCfg = RigidBodyCfg(),
    new_throttle: Optional[torch.Tensor] = None,
) -> DroneState:
    """Semi-implicit Euler step (velocities first, damped and clamped)."""
    inv_mass = 1.0 / params.mass
    accel = force_w * inv_mass[..., None]
    accel = torch.cat([accel[..., :2], accel[..., 2:] - 9.81], dim=-1)  # gravity
    vel = state.vel + dt * accel
    vel = vel * max(0.0, 1.0 - cfg.linear_damping * dt)
    speed = torch.linalg.vector_norm(vel, dim=-1, keepdim=True)
    vel = vel * torch.clamp(cfg.max_linear_velocity / (speed + 1e-9), max=1.0)

    omega_b = state.body_rate
    i_omega = params.inertia * omega_b
    ang_acc_b = (torque_b - torch.linalg.cross(omega_b, i_omega, dim=-1)) / params.inertia
    omega_b = omega_b + dt * ang_acc_b
    omega_b = omega_b * max(0.0, 1.0 - cfg.angular_damping * dt)
    rate = torch.linalg.vector_norm(omega_b, dim=-1, keepdim=True)
    omega_b = omega_b * torch.clamp(cfg.max_angular_velocity / (rate + 1e-9), max=1.0)
    angvel = quat_rotate(state.quat, omega_b)

    pos = state.pos + dt * vel
    quat = quat_integrate(state.quat, angvel, dt)

    if cfg.ground_collision:
        below = pos[..., 2:3] < 0.0
        pos = torch.cat([pos[..., :2], torch.clamp(pos[..., 2:3], min=0.0)], dim=-1)
        vel_up = torch.cat([vel[..., :2], torch.clamp(vel[..., 2:3], min=0.0)], dim=-1)
        vel = torch.where(below, vel_up, vel)

    return DroneState(
        pos=pos,
        quat=quat,
        vel=vel,
        angvel=angvel,
        throttle=state.throttle if new_throttle is None else new_throttle,
    )


def step(
    params: QuadrotorParams,
    state: DroneState,
    rotor_cmds: torch.Tensor,
    dt: float,
    cfg: RigidBodyCfg = RigidBodyCfg(),
    enable_downwash: bool = True,
    ext_force_w: Optional[torch.Tensor] = None,
) -> Tuple[DroneState, torch.Tensor]:
    """One quadrotor tick → (new_state, ‖throttle_t − throttle_{t−1}‖).
    `ext_force_w` (..., 3) is an external world-frame force at the centre of
    mass, added after the drag (an assembly's constraint forces: the
    transport group's rods)."""
    new_throttle, thrusts, moments = rotor_response(params, state.throttle, rotor_cmds, dt)
    force_b, torque_b = body_wrench(params, thrusts, moments)
    force_w = quat_rotate(state.quat, force_b)
    if enable_downwash and state.pos.shape[-2] > 1:
        force_w = force_w + downwash_forces(state.pos, force_w)
    force_w = force_w + (params.drag_coef * params.mass)[..., None] * state.vel
    if ext_force_w is not None:
        force_w = force_w + ext_force_w
    new_state = integrate(params, state, force_w, torque_b, dt, cfg, new_throttle=new_throttle)
    throttle_diff = torch.linalg.vector_norm(new_throttle - state.throttle, dim=-1)
    return new_state, throttle_diff
