"""Domain randomization of quadrotor parameters (counterpart of
mupe_tpu/dynamics/randomization.py; reference MultirotorBase
setup_randomization / _randomize, multirotor.py:406-697): per-env scaling of
mass, inertia, thrust-to-weight, force-to-moment, drag and rotor offsets,
absolute rotor time constants, and the normalized "intrinsics" vector of
privileged / adaptive policies.

Randomized parameters are a `QuadrotorParams` whose leaves carry a leading
[num_envs, 1] shape; they broadcast against the [E, 1, .] drone state.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from .params import QuadrotorParams

# uniform(shape, lo, hi) -> tensor: the draw every randomized leaf takes
Uniform = Callable[[Sequence[int], float, float], torch.Tensor]

INTRINSICS_KEYS = ("mass", "inertia", "KF", "KM", "tau_up", "tau_down", "drag_coef",
                   "rotor_offset")


@dataclasses.dataclass(frozen=True)
class RandomizationCfg:
    """Uniform scaling ranges, None = not randomized (reference
    cfg/task/Hover.yaml:37-48); `tau_up` / `tau_down` are absolute."""

    mass_scale: Optional[Tuple[float, float]] = None
    inertia_scale: Optional[Tuple[float, float]] = None
    t2w_scale: Optional[Tuple[float, float]] = None      # thrust-to-weight
    f2m_scale: Optional[Tuple[float, float]] = None      # force-to-moment
    drag_coef_scale: Optional[Tuple[float, float]] = None
    rotor_offset_scale: Optional[Tuple[float, float]] = None
    tau_up: Optional[Tuple[float, float]] = None
    tau_down: Optional[Tuple[float, float]] = None


def randomize_params(
    uniform: Uniform,
    base: QuadrotorParams,
    cfg: RandomizationCfg,
    num_envs: int,
) -> Tuple[QuadrotorParams, Dict[str, torch.Tensor]]:
    """Sample per-env parameters → (params with [E, 1, ...] leaves, the
    intrinsics dict normalized by the nominal values).  `uniform` makes each
    enabled range's draw, in the JAX package's order (mass, inertia, t2w,
    f2m, drag, rotor offset, tau_up, tau_down)."""
    r = base.num_rotors
    e1 = (num_envs, 1)

    mass = base.mass.expand(e1)
    if cfg.mass_scale:
        mass = base.mass * uniform(e1, *cfg.mass_scale)
    inertia = base.inertia.expand(e1 + (3,))
    if cfg.inertia_scale:
        inertia = base.inertia * uniform(e1 + (1,), *cfg.inertia_scale)
    kf = base.kf.expand(e1 + (r,))
    if cfg.t2w_scale:
        # KF = t2w · m · g (multirotor.py:671-675)
        t2w0 = base.kf / (base.mass * 9.81)
        kf = t2w0 * uniform(e1 + (1,), *cfg.t2w_scale) * mass[..., None] * 9.81
    km = base.km.expand(e1 + (r,))
    if cfg.f2m_scale:
        # KM = KF / f2m (multirotor.py:676-680)
        f2m0 = base.kf / base.km
        km = kf / (f2m0 * uniform(e1 + (1,), *cfg.f2m_scale))
    drag = base.drag_coef.expand(e1)
    if cfg.drag_coef_scale:
        drag = base.drag_coef * uniform(e1, *cfg.drag_coef_scale)
    rotor_pos = base.rotor_pos.expand(e1 + (r, 3))
    rotor_offset = torch.zeros(e1, device=base.mass.device)
    if cfg.rotor_offset_scale:
        rotor_offset = uniform(e1, *cfg.rotor_offset_scale)
        xy = base.rotor_pos[..., :2] * (1.0 + rotor_offset[..., None, None])
        rotor_pos = torch.cat([xy, base.rotor_pos[..., 2:].expand(xy.shape[:-1] + (1,))], dim=-1)
    tau_up = base.tau_up.expand(e1 + (r,))
    if cfg.tau_up:
        tau_up = uniform(e1 + (r,), *cfg.tau_up)
    tau_down = base.tau_down.expand(e1 + (r,))
    if cfg.tau_down:
        tau_down = uniform(e1 + (r,), *cfg.tau_down)

    params = dataclasses.replace(
        base, mass=mass, inertia=inertia, kf=kf, km=km, drag_coef=drag,
        rotor_pos=rotor_pos, tau_up=tau_up, tau_down=tau_down,
    )
    intrinsics = {
        "mass": (mass / base.mass)[..., None],
        "inertia": inertia / base.inertia,
        "KF": kf / base.kf,
        "KM": km / base.km,
        "tau_up": tau_up,
        "tau_down": tau_down,
        "drag_coef": drag[..., None],
        "rotor_offset": rotor_offset[..., None],
    }
    return params, intrinsics


def intrinsics_vector(intrinsics: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The intrinsics dict flattened into the privileged observation vector
    (the intrinsics_spec's order, multirotor.py:78-88)."""
    return torch.cat([intrinsics[k] for k in INTRINSICS_KEYS], dim=-1)
