"""Quadrotor physical parameters and the drone zoo (counterpart of
mupe_tpu/dynamics/params.py): every model of the JAX package's zoo, the
Crazyflie (the main path's), its deployment copy, Hummingbird, Iris, and the
multirotors of 6 and 12 rotors (Firefly, Neo11, OMAV).  `QuadrotorParams`
leaves may carry leading [num_envs, 1] dimensions (domain randomization,
`dynamics/randomization.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

# the drone zoo: physical constants of the reference asset YAMLs
# (robots/assets/usd/*.yaml); kf_i = max_rot_vel_i^2 * force_constant_i, km_i likewise
DRONE_ZOO: Dict[str, Dict[str, Any]] = {
    # reference: robots/assets/usd/crazyflie.yaml (calibrated sim-to-real params)
    "crazyflie": dict(
        mass=0.0321,
        inertia=(1.4e-5, 1.4e-5, 2.17e-5),
        arm_length=0.043,
        rotor_angles=(0.78539816, 2.35619449, 3.92699082, 5.49778714),
        directions=(-1.0, 1.0, -1.0, 1.0),
        force_constants=2.350347298350041e-08,
        moment_constants=7.24e-10,
        max_rotation_velocities=2315.0,
        time_constant=0.025,
        drag_coef=0.0,
        target_clip=1.0,
        max_thrust_ratio=0.9,
        fixed_yaw=False,
        num_rotors=4,
    ),
    # reference: robots/assets/usd/crazyflie_deploy.yaml (deployment stage)
    "crazyflie_deploy": dict(
        mass=0.0321,
        inertia=(1.4e-5, 1.4e-5, 2.17e-5),
        arm_length=0.043,
        rotor_angles=(0.78539816, 2.35619449, 3.92699082, 5.49778714),
        directions=(-1.0, 1.0, -1.0, 1.0),
        force_constants=2.350347298350041e-08,
        moment_constants=7.24e-10,
        max_rotation_velocities=2315.0,
        time_constant=0.025,
        drag_coef=0.0,
        target_clip=1.0,
        max_thrust_ratio=0.9,
        fixed_yaw=False,
        num_rotors=4,
    ),
    # reference: robots/assets/usd/hummingbird.yaml
    "hummingbird": dict(
        mass=0.716,
        inertia=(0.007, 0.007, 0.012),
        arm_length=0.17,
        rotor_angles=(0.0, 1.57079632679, 3.14159265359, -1.57079632679),
        directions=(-1.0, 1.0, -1.0, 1.0),
        force_constants=8.54858e-06,
        moment_constants=1.3677728816219314e-07,
        max_rotation_velocities=838.0,
        time_constant=0.025,
        drag_coef=0.2,
        target_clip=1.0,
        max_thrust_ratio=1.0,
        fixed_yaw=False,
        num_rotors=4,
    ),
    # reference: robots/assets/usd/firefly.yaml (hexarotor)
    "firefly": dict(
        mass=1.56779,
        inertia=(0.0347563, 0.0458929, 0.0977),
        arm_length=0.215,
        rotor_angles=(
            0.52359877559, 1.57079632679, 2.61799387799,
            -2.61799387799, -1.57079632679, -0.52359877559,
        ),
        directions=(1.0, -1.0, 1.0, -1.0, 1.0, -1.0),
        force_constants=8.54858e-06,
        moment_constants=1.3677728816219314e-07,
        max_rotation_velocities=838.0,
        time_constant=0.025,
        drag_coef=0.3,
        target_clip=1.0,
        max_thrust_ratio=1.0,
        fixed_yaw=False,
        num_rotors=6,
    ),
    # reference: robots/assets/usd/iris.yaml
    "iris": dict(
        mass=1.52,
        inertia=(0.0347563, 0.0458929, 0.0977),
        arm_length=0.255539,
        rotor_angles=(-0.533708, 2.565218, 0.533708, -2.565218),
        directions=(1.0, 1.0, -1.0, -1.0),
        force_constants=8.54858e-06,
        moment_constants=1.3677728816219314e-07,
        max_rotation_velocities=838.0,
        time_constant=0.025,
        drag_coef=0.2,
        target_clip=1.0,
        max_thrust_ratio=1.0,
        fixed_yaw=False,
        num_rotors=4,
    ),
    # reference: robots/assets/usd/neo11.yaml (hexarotor)
    "neo11": dict(
        mass=3.42,
        inertia=(0.0608, 0.0688, 0.1489),
        arm_length=0.2895,
        rotor_angles=(
            0.52359877559, 1.57079632679, 2.61799387799,
            -2.61799387799, -1.57079632679, -0.52359877559,
        ),
        directions=(1.0, -1.0, 1.0, -1.0, 1.0, -1.0),
        force_constants=1.269e-05,
        moment_constants=2.12608256333624e-07,
        max_rotation_velocities=1047.2,
        time_constant=0.025,
        drag_coef=0.3,
        target_clip=1.0,
        max_thrust_ratio=1.0,
        fixed_yaw=False,
        num_rotors=6,
    ),
    # reference: robots/assets/usd/omav.yaml (12-rotor omnidirectional; modeled
    # here as a planar 12-rotor ring — tilt actuation is out of scope, as the
    # reference never trains it)
    "omav": dict(
        mass=4.04,
        inertia=(0.3, 0.3, 0.5),
        arm_length=0.3,
        rotor_angles=tuple(np.linspace(0.0, 2.0 * np.pi, 12, endpoint=False).tolist()),
        directions=(1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0, 1.0, -1.0, 1.0, 1.0, -1.0),
        force_constants=7.2e-06,
        moment_constants=1.0799999999999999e-07,
        max_rotation_velocities=1700.0,
        time_constant=0.025,
        drag_coef=0.3,
        target_clip=1.0,
        max_thrust_ratio=1.0,
        fixed_yaw=False,
        num_rotors=12,
    ),
}


@dataclasses.dataclass
class QuadrotorParams:
    """Per-drone physical parameters as tensors on one device."""

    mass: torch.Tensor         # ()     kg
    inertia: torch.Tensor      # (3,)   diagonal kg m^2
    kf: torch.Tensor           # (R,)   max thrust per rotor [N]
    km: torch.Tensor           # (R,)   max yaw moment per rotor [N m]
    directions: torch.Tensor   # (R,)   +1 ccw / -1 cw
    tau_up: torch.Tensor       # (R,)   rotor spin-up time constant
    tau_down: torch.Tensor     # (R,)   rotor spin-down time constant
    rotor_pos: torch.Tensor    # (R, 3) rotor offsets in body frame [m]
    drag_coef: torch.Tensor    # ()     body drag coefficient
    target_clip: float = 1.0
    max_thrust_ratio: float = 1.0
    fixed_yaw: bool = False
    num_rotors: int = 4

    @property
    def gravity(self) -> torch.Tensor:
        return self.mass * 9.81

    @property
    def hover_throttle(self) -> torch.Tensor:
        """Steady-state throttle that exactly cancels gravity."""
        return torch.sqrt(self.gravity / torch.sum(self.kf, dim=-1))


def make_params(
    model: str = "crazyflie", device: torch.device | str = "cpu"
) -> QuadrotorParams:
    """Build `QuadrotorParams` for a drone-zoo model (float32)."""
    if model not in DRONE_ZOO:
        raise KeyError(f"unknown drone model {model!r}; the zoo has {sorted(DRONE_ZOO)}")
    cfg = DRONE_ZOO[model]
    r = cfg["num_rotors"]
    angles = np.asarray(cfg["rotor_angles"], dtype=np.float64)
    arm = float(cfg["arm_length"])
    rotor_pos = np.stack(
        [arm * np.cos(angles), arm * np.sin(angles), np.zeros_like(angles)], axis=-1
    )
    omega_max = np.full((r,), cfg["max_rotation_velocities"], dtype=np.float64)
    kf = omega_max**2 * np.full((r,), cfg["force_constants"], dtype=np.float64)
    km = omega_max**2 * np.full((r,), cfg["moment_constants"], dtype=np.float64)

    def t(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float32), device=device)

    return QuadrotorParams(
        mass=t(cfg["mass"]),
        inertia=t(cfg["inertia"]),
        kf=t(kf),
        km=t(km),
        directions=t(cfg["directions"]),
        tau_up=t(np.full((r,), cfg["time_constant"])),
        tau_down=t(np.full((r,), cfg["time_constant"])),
        rotor_pos=t(rotor_pos),
        drag_coef=t(cfg["drag_coef"]),
        target_clip=float(cfg["target_clip"]),
        max_thrust_ratio=float(cfg["max_thrust_ratio"]),
        fixed_yaw=bool(cfg["fixed_yaw"]),
        num_rotors=r,
    )


@dataclasses.dataclass(frozen=True)
class RigidBodyCfg:
    """PhysX-style rigid-body integration properties."""

    linear_damping: float = 0.2
    angular_damping: float = 0.2
    max_linear_velocity: float = 1000.0
    max_angular_velocity: float = 1000.0
    ground_collision: bool = True
