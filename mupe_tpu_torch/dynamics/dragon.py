"""Dragon: the articulated multi-link drone
(counterpart of mupe_tpu/dynamics/dragon.py).

A chain of `num_links` rigid link modules, each carrying a 2-rotor gimbal
module; consecutive links joined by D6 joints limited to ±90° about local
y / z with position drives, the gimbals velocity-driven, and a flat state
vector [pos, rot, vel6, heading, up | 2·throttle−1 | gimbal/π | link-joint/π]
per link.  Every link is a free 6-DoF rigid body in maximal coordinates
([E, L]-batched, semi-implicit Euler), and the joints are compliant: a stiff
point-to-point spring-damper at the anchor (±joint_anchor on the link
x-axis), a stiff spring locking the relative roll, and the drives' gains on
the y / z axes.  No iterative solve; stable at dt = 0.01 with 4 substeps.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..core import const, quat_axis, quat_conjugate, quat_integrate, quat_mul, quat_rotate


@dataclasses.dataclass(frozen=True)
class DragonCfg:
    """Geometry and actuation constants: 4 links 0.3 m apart, 2 rotors a
    link (kf 7.2e-6, km 1.08e-7, ω_max 800), joint drives of stiffness 1 and
    damping 0.5."""

    num_links: int = 4
    link_mass: float = 0.4
    link_inertia: Tuple[float, float, float] = (3.0e-3, 3.0e-3, 5.0e-3)
    link_spacing: float = 0.3
    joint_anchor: float = 0.15
    rotor_arm: float = 0.08
    force_constant: float = 7.2e-6
    moment_constant: float = 1.08e-7
    max_rotation_velocity: float = 800.0
    rotor_tau: float = 0.12
    joint_kp: float = 400.0
    joint_kd: float = 12.0
    rot_lock_kp: float = 2.0
    rot_lock_kd: float = 0.1
    drive_stiffness: float = 1.0
    drive_damping: float = 0.5
    gimbal_rate: float = np.pi / 2.0
    linear_damping: float = 0.05
    angular_damping: float = 0.01
    # inner substeps a control step: the drives' relative damping on the
    # links' inertia needs dt_sub <= 2.5 ms
    substeps: int = 4

    @property
    def num_rotors(self) -> int:
        return 2 * self.num_links

    @property
    def action_split(self) -> Tuple[int, int, int]:
        """(rotor commands, gimbal velocity targets, link-joint position targets)."""
        return (self.num_rotors, 2 * self.num_links, 2 * (self.num_links - 1))

    @property
    def action_dim(self) -> int:
        return sum(self.action_split)

    @property
    def state_dim(self) -> int:
        # per link pos 3 + quat 4 + vel6 + heading 3 + up 3 + throttle 2 +
        # gimbal 2; 2 angles a link joint
        return self.num_links * 23 + (self.num_links - 1) * 2

    @property
    def kf(self) -> float:
        return self.force_constant * self.max_rotation_velocity**2

    @property
    def km(self) -> float:
        return self.moment_constant * self.max_rotation_velocity**2


@dataclasses.dataclass
class DragonLinkState:
    """[E, L]-batched maximal-coordinate state of the link chain."""

    pos: torch.Tensor       # [E, L, 3] world
    quat: torch.Tensor      # [E, L, 4] wxyz body→world
    vel: torch.Tensor       # [E, L, 3] world linear velocity
    angvel: torch.Tensor    # [E, L, 3] world angular velocity
    throttle: torch.Tensor  # [E, 2L]
    gimbal: torch.Tensor    # [E, L, 2] gimbal joint angles (rad)


def dragon_init(cfg: DragonCfg, pos0: torch.Tensor) -> DragonLinkState:
    """The chain extended along +x from `pos0` [E, 3] at hover throttle."""
    e, dev, L = pos0.shape[0], pos0.device, cfg.num_links
    offs = (torch.arange(L, device=dev)[:, None]
            * const((cfg.link_spacing, 0.0, 0.0), dev))
    quat = torch.zeros((e, L, 4), device=dev)
    quat[..., 0] = 1.0
    hover = torch.sqrt(torch.tensor(cfg.link_mass * 9.81 / (2.0 * cfg.kf), device=dev))
    return DragonLinkState(
        pos=pos0[:, None, :] + offs[None],
        quat=quat,
        vel=torch.zeros((e, L, 3), device=dev),
        angvel=torch.zeros((e, L, 3), device=dev),
        throttle=hover.expand(e, cfg.num_rotors).clone(),
        gimbal=torch.zeros((e, L, 2), device=dev),
    )


def _gimbal_axis(gimbal: torch.Tensor) -> torch.Tensor:
    """Rotor thrust axis in the link frame: ẑ tilted about link y (g0),
    then x (g1)."""
    gy, gx = gimbal[..., 0], gimbal[..., 1]
    return torch.stack([torch.sin(gy) * torch.cos(gx), -torch.sin(gx),
                        torch.cos(gy) * torch.cos(gx)], dim=-1)


def _small_angles(q_rel: torch.Tensor) -> torch.Tensor:
    """Relative rotation → per-axis angles (2 · vector part, the sign of w,
    taken as 1 where w is 0): exact for small angles, monotone to ±π."""
    s = torch.sign(q_rel[..., :1])
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    return 2.0 * q_rel[..., 1:] * s


def dragon_step(cfg: DragonCfg, state: DragonLinkState, action: torch.Tensor,
                dt: float) -> DragonLinkState:
    """One control step (`action` [E, action_dim] in [-1, 1]) =
    `cfg.substeps` physics steps: rotor lag → per-link wrench → compliant
    joint forces and drives → semi-implicit Euler."""
    sub_dt = dt / cfg.substeps
    for _ in range(cfg.substeps):
        state = _dragon_substep(cfg, state, action, sub_dt)
    return state


def _dragon_substep(cfg: DragonCfg, state: DragonLinkState, action: torch.Tensor,
                    dt: float) -> DragonLinkState:
    e, dev, L = action.shape[0], action.device, cfg.num_links
    n_rot, n_gim, _ = cfg.action_split
    rotor_cmds = action[:, :n_rot]
    gimbal_cmds = action[:, n_rot:n_rot + n_gim].reshape(e, L, 2)
    link_cmds = action[:, n_rot + n_gim:].reshape(e, L - 1, 2)

    # rotors: first-order lag, thrust and moment curves
    target = torch.sqrt(torch.clamp((rotor_cmds + 1.0) * 0.5, 0.0, 1.0))
    throttle = state.throttle + (dt / cfg.rotor_tau) * (target - state.throttle)
    t2 = torch.square(throttle).reshape(e, L, 2)
    thrust = t2 * cfg.kf                                          # [E, L, 2]
    moment = -const((1.0, -1.0), dev) * t2 * cfg.km               # about the axis

    # gimbal joints: velocity targets integrate to angles (±π/2)
    gimbal = torch.clamp(
        state.gimbal + dt * torch.clamp(gimbal_cmds, -1.0, 1.0) * cfg.gimbal_rate,
        -np.pi / 2, np.pi / 2)
    axis_w = quat_rotate(state.quat, _gimbal_axis(gimbal))       # [E, L, 3]

    # per-link rotor wrench: both rotors on the gimbal axis at ±rotor_arm on y
    f_rot = torch.sum(thrust[..., None] * axis_w[..., None, :], dim=-2)
    r_plus = quat_rotate(state.quat, const((0.0, cfg.rotor_arm, 0.0), dev).expand(axis_w.shape))
    tau_rot = (torch.linalg.cross(r_plus, thrust[..., 0:1] * axis_w, dim=-1)
               + torch.linalg.cross(-r_plus, thrust[..., 1:2] * axis_w, dim=-1)
               + torch.sum(moment[..., None] * axis_w[..., None, :], dim=-2))

    # compliant D6 joints between consecutive links
    q_par, q_chd = state.quat[:, :-1], state.quat[:, 1:]
    a_par = state.pos[:, :-1] + quat_rotate(
        q_par, const((cfg.joint_anchor, 0.0, 0.0), dev).expand(e, L - 1, 3))
    a_chd = state.pos[:, 1:] + quat_rotate(
        q_chd, const((-cfg.joint_anchor, 0.0, 0.0), dev).expand(e, L - 1, 3))
    r_par = a_par - state.pos[:, :-1]
    r_chd = a_chd - state.pos[:, 1:]
    v_par = state.vel[:, :-1] + torch.linalg.cross(state.angvel[:, :-1], r_par, dim=-1)
    v_chd = state.vel[:, 1:] + torch.linalg.cross(state.angvel[:, 1:], r_chd, dim=-1)
    f_joint = cfg.joint_kp * (a_chd - a_par) + cfg.joint_kd * (v_chd - v_par)

    # rotational: relative orientation in the parent frame
    ang = _small_angles(quat_mul(quat_conjugate(q_par), q_chd))  # [E, L-1, 3]
    rel_b = quat_rotate(quat_conjugate(q_par), state.angvel[:, 1:] - state.angvel[:, :-1])
    targets = torch.clamp(link_cmds, -1.0, 1.0) * (np.pi / 2)     # y / z drives
    tau_b = torch.stack([
        -cfg.rot_lock_kp * ang[..., 0] - cfg.rot_lock_kd * rel_b[..., 0],
        cfg.drive_stiffness * (targets[..., 0] - ang[..., 1]) - cfg.drive_damping * rel_b[..., 1],
        cfg.drive_stiffness * (targets[..., 1] - ang[..., 2]) - cfg.drive_damping * rel_b[..., 2],
    ], dim=-1)
    tau_joint = quat_rotate(q_par, tau_b)                         # world frame

    # the joint wrenches onto the chain's ends: a static pad, summed in the
    # reference's order
    zero = torch.zeros((e, 1, 3), device=dev)
    f_net = f_rot + torch.cat([f_joint, zero], dim=1) - torch.cat([zero, f_joint], dim=1)
    f_net = f_net + const((0.0, 0.0, -cfg.link_mass * 9.81), dev)
    f_net = f_net - cfg.linear_damping * state.vel
    tau_net = (tau_rot
               + torch.cat([torch.linalg.cross(r_par, f_joint, dim=-1) - tau_joint, zero], dim=1)
               + torch.cat([zero, torch.linalg.cross(r_chd, -f_joint, dim=-1) + tau_joint],
                           dim=1)
               - cfg.angular_damping * state.angvel)

    # semi-implicit Euler; the gyroscopic term in the body frame
    inertia = const(cfg.link_inertia, dev)
    vel = state.vel + dt * f_net / cfg.link_mass
    pos = state.pos + dt * vel
    q_inv = quat_conjugate(state.quat)
    w_b = quat_rotate(q_inv, state.angvel)
    dw_b = (quat_rotate(q_inv, tau_net) - torch.linalg.cross(w_b, inertia * w_b, dim=-1)) / inertia
    w_b = w_b + dt * dw_b
    angvel = quat_rotate(state.quat, w_b)
    return DragonLinkState(pos=pos, quat=quat_integrate(state.quat, angvel, dt), vel=vel,
                           angvel=angvel, throttle=throttle, gimbal=gimbal)


def dragon_state_vector(cfg: DragonCfg, state: DragonLinkState) -> torch.Tensor:
    """Flat observation [E, state_dim]: per link [pos, rot, vel6, heading,
    up] flattened, then 2·throttle−1, gimbal/π, link-joint angles/π."""
    e = state.pos.shape[0]
    per_link = torch.cat([state.pos, state.quat, state.vel, state.angvel,
                          quat_axis(state.quat, 0), quat_axis(state.quat, 2)],
                         dim=-1).reshape(e, -1)
    q_rel = quat_mul(quat_conjugate(state.quat[:, :-1]), state.quat[:, 1:])
    joint_ang = _small_angles(q_rel)[..., 1:3].reshape(e, -1) / math.pi
    return torch.cat([per_link, state.throttle * 2.0 - 1.0,
                      state.gimbal.reshape(e, -1) / math.pi, joint_ang], dim=-1)
