"""TransportationGroup: N drones carrying a slung payload on rigid bars
(counterpart of mupe_tpu/dynamics/transport.py).

Four drones at (±0.5, ±0.5, 0) in the group frame, a 2 kg box payload
hanging 1.1 m below the group origin, each drone joined to its payload
anchor by a 1 m bar.  Every body is a free rigid body and each bar a stiff
rod (a spring-damper along the drone ↔ anchor line, with tangential
damping for the rigid link's lateral stiffness); the drones step through
the quadrotor dynamics (rotor lag, drag, downwash) with the rod force
injected as an external force at the centre of mass.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from ..core import const, quat_conjugate, quat_mul, quat_rotate
from .params import DRONE_ZOO, QuadrotorParams, RigidBodyCfg, make_params
from .quadrotor import DroneState, hover_state
from .quadrotor import step as drone_step


@dataclasses.dataclass(frozen=True)
class TransportCfg:
    """Assembly constants (the reference transportation group's)."""

    drone_model: str = "firefly"
    n_drones: int = 4
    payload_mass: float = 2.0
    payload_half_extents: Tuple[float, float, float] = (0.25, 0.25, 0.1)
    payload_offset_z: float = -1.1      # in the group frame
    bar_length: float = 1.0
    bar_mass: float = 0.03              # half lumped onto the payload
    linear_damping: float = 0.1         # the payload's rigid-body damping
    angular_damping: float = 0.1
    # compliant rod gains (sag about 2 mm under a rod's share of the load)
    rod_stiffness: float = 400.0
    rod_damping: float = 20.0
    # damping of the relative velocity across the rod: the reference's bars
    # are rigid links, which resist lateral motion too
    rod_tangential_damping: float = 1.5
    substeps: int = 4

    @property
    def drone_offsets(self) -> torch.Tensor:
        """Drone spawn points in the group frame [n, 3]."""
        return torch.tensor([[0.5, 0.5, 0.0], [0.5, -0.5, 0.0],
                             [-0.5, -0.5, 0.0], [-0.5, 0.5, 0.0]][: self.n_drones])

    @property
    def anchor_body(self) -> torch.Tensor:
        """Rod anchors in the payload's body frame [n, 3]: under each drone,
        on the payload's top plane."""
        off = self.drone_offsets
        top = torch.full((off.shape[0], 1), self.payload_half_extents[2])
        return torch.cat([off[:, :2], top], dim=-1)

    @property
    def payload_inertia(self) -> torch.Tensor:
        hx, hy, hz = self.payload_half_extents
        m = self.payload_mass
        return torch.tensor([m / 3.0 * (hy * hy + hz * hz), m / 3.0 * (hx * hx + hz * hz),
                             m / 3.0 * (hx * hx + hy * hy)])


@functools.lru_cache(maxsize=None)
def _on(cfg: TransportCfg, name: str, device: torch.device) -> torch.Tensor:
    """The cfg's tensor property `name` on `device`, copied there once."""
    return getattr(cfg, name).to(device)


@dataclasses.dataclass
class TransportState:
    """The drone bodies [E, n, ·] and the payload's rigid body [E, ·]."""

    drones: DroneState
    payload_pos: torch.Tensor    # [E, 3]
    payload_quat: torch.Tensor   # [E, 4] wxyz
    payload_vel: torch.Tensor    # [E, 3]
    payload_omega: torch.Tensor  # [E, 3] body-frame angular velocity


def transport_init(cfg: TransportCfg, params: QuadrotorParams,
                   origin: torch.Tensor) -> TransportState:
    """The assembly at its group origins `origin` [E, 3], at hover."""
    e, dev = origin.shape[0], origin.device
    drone_pos = origin[:, None, :] + _on(cfg, "drone_offsets", dev)[None]
    identity = const((1.0, 0.0, 0.0, 0.0), dev)
    drones = hover_state(params, drone_pos, identity.expand(e, cfg.n_drones, 4).clone())
    return TransportState(
        drones=drones,
        payload_pos=origin + const((0.0, 0.0, cfg.payload_offset_z), dev),
        payload_quat=identity.expand(e, 4).clone(),
        payload_vel=torch.zeros((e, 3), device=dev),
        payload_omega=torch.zeros((e, 3), device=dev),
    )


def _rod_forces(cfg: TransportCfg, state: TransportState):
    """(each drone's rod force [E, n, 3], the payload's reaction force
    [E, 3] and torque [E, 3]), world frame."""
    dev = state.payload_pos.device
    r_w = quat_rotate(state.payload_quat[:, None, :],
                      _on(cfg, "anchor_body", dev)[None])        # [E, n, 3]
    anchors_w = state.payload_pos[:, None, :] + r_w
    omega_w = quat_rotate(state.payload_quat, state.payload_omega)
    anchor_vel = (state.payload_vel[:, None, :]
                  + torch.linalg.cross(omega_w[:, None, :].expand(r_w.shape), r_w, dim=-1))
    d = state.drones.pos - anchors_w
    dist = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    u = d / (dist + 1e-9)
    rel_v = state.drones.vel - anchor_vel
    v_rad = torch.sum(rel_v * u, dim=-1, keepdim=True)
    tension = cfg.rod_stiffness * (dist - cfg.bar_length) + cfg.rod_damping * v_rad
    v_tan = rel_v - v_rad * u
    f_drone = -tension * u - cfg.rod_tangential_damping * v_tan
    f_payload_w = -torch.sum(f_drone, dim=1)
    tau_payload_w = -torch.sum(torch.linalg.cross(r_w, f_drone, dim=-1), dim=1)
    return f_drone, f_payload_w, tau_payload_w


def transport_step(cfg: TransportCfg, params: QuadrotorParams, state: TransportState,
                   rotor_cmds: torch.Tensor, dt: float,
                   body_cfg: RigidBodyCfg = RigidBodyCfg()) -> TransportState:
    """One assembly tick of `cfg.substeps` substeps: the rods' forces, the
    drones' quadrotor step with them (downwash on), the payload's
    semi-implicit Euler."""
    h = dt / cfg.substeps
    dev = state.payload_pos.device
    inertia = _on(cfg, "payload_inertia", dev)
    gravity = const((0.0, 0.0, -9.81), dev)
    # half of each bar's mass rides on the payload
    m_pay = cfg.payload_mass + 0.5 * cfg.bar_mass * cfg.n_drones
    lin = max(0.0, 1.0 - cfg.linear_damping * h)
    ang = max(0.0, 1.0 - cfg.angular_damping * h)
    for _ in range(cfg.substeps):
        f_drone, f_pay_w, tau_pay_w = _rod_forces(cfg, state)
        drones, _ = drone_step(params, state.drones, rotor_cmds, h, body_cfg,
                               enable_downwash=True, ext_force_w=f_drone)
        vel = (state.payload_vel + h * (f_pay_w / m_pay + gravity)) * lin
        pos = state.payload_pos + h * vel
        tau_b = quat_rotate(quat_conjugate(state.payload_quat), tau_pay_w)
        om = state.payload_omega
        ang_acc = (tau_b - torch.linalg.cross(om, inertia * om, dim=-1)) / inertia
        om = (om + h * ang_acc) * ang
        dq = quat_mul(state.payload_quat,
                      torch.cat([torch.zeros_like(om[..., :1]), om], dim=-1)) * 0.5
        quat = state.payload_quat + h * dq
        quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
        state = TransportState(drones=drones, payload_pos=pos, payload_quat=quat,
                               payload_vel=vel, payload_omega=om)
    return state


def make_transport_params(cfg: TransportCfg,
                          device: torch.device | str = "cpu") -> QuadrotorParams:
    if cfg.drone_model not in DRONE_ZOO:
        raise KeyError(f"unknown drone model {cfg.drone_model!r}")
    return make_params(cfg.drone_model, device)
