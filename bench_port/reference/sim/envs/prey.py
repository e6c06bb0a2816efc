"""Scripted evader: potential-field escape policy
(counterpart of mupe_tpu/envs/prey.py)."""
from __future__ import annotations

import torch

from .geometry import line_blocked_by_cylinder


def prey_force(
    drone_pos: torch.Tensor,      # [E, n, 3]
    target_pos: torch.Tensor,     # [E, 1, 3]
    cylinder_pos: torch.Tensor,   # [E, C, 3]
    cylinder_size: float,
    arena_size: float,
    max_height: float,
    target_detect_radius: float,
) -> torch.Tensor:
    """Total potential-field force on the evader → [E, 1, 3]."""
    # pursuer repulsion: rpos = drone − target
    rpos = drone_pos[:, :, None, :] - target_pos[:, None, :, :]   # [E, n, 1, 3]
    dist = torch.linalg.vector_norm(rpos, dim=-1)                 # [E, n, 1]
    blocked = line_blocked_by_cylinder(drone_pos, target_pos, cylinder_pos, cylinder_size)
    active = (dist < target_detect_radius) & (~blocked[..., None])
    direction = -rpos / (dist[..., None] + 1e-5)
    force_p = direction * (1.0 / (dist[..., None] + 1e-5)) * active[..., None]
    force = torch.sum(force_p, dim=1)                             # [E, 1, 3]

    # arena wall, ceiling and floor
    xy = target_pos[..., :2]
    origin_dist = torch.linalg.vector_norm(xy, dim=-1)            # [E, 1]
    dir_xy = -xy / (origin_dist[..., None] + 1e-5)
    out = torch.square(xy[..., 0]) + torch.square(xy[..., 1]) > arena_size**2
    mag = torch.where(
        out, torch.full_like(origin_dist, 1.0 / 1e-5),
        1.0 / (arena_size - origin_dist + 1e-5),
    )
    force_r_xy = dir_xy * mag[..., None]
    z = target_pos[..., 2]
    dz_top = max_height - z
    f_top = torch.where(
        z > max_height, torch.full_like(z, -1.0 / 1e-5),
        -dz_top / (torch.square(dz_top) + 1e-5),
    )
    f_bot = torch.where(
        z < 0.0, torch.full_like(z, 1.0 / 1e-5), z / (torch.square(z) + 1e-5)
    )
    force = force + torch.cat([force_r_xy, (f_top + f_bot)[..., None]], dim=-1)

    # repulsion from active cylinders in range
    t_c_rpos = target_pos[:, :, None, :2] - cylinder_pos[:, None, :, :2]  # [E,1,C,2]
    d_c = torch.linalg.vector_norm(t_c_rpos, dim=-1)                      # [E,1,C]
    inactive = (cylinder_pos[..., 2] < 0.0)[:, None, :]
    active_c = ((~inactive) & (d_c < target_detect_radius)).to(drone_pos.dtype)[..., None]
    dir_c = t_c_rpos / (d_c[..., None] + 1e-5)
    # Denominator guard (mupe_tpu/envs/prey.py:75-76): d_c − r + 1e-5 can be
    # exactly zero when the evader stands on a cylinder wall; clamp its
    # magnitude away from zero, keeping its sign.
    denom = (d_c - cylinder_size)[..., None] + 1e-5
    tiny = torch.where(denom < 0, torch.full_like(denom, -1e-6), torch.full_like(denom, 1e-6))
    denom = torch.where(torch.abs(denom) < 1e-6, tiny, denom)
    force_c_xy = torch.sum(active_c * dir_c * (1.0 / denom), dim=2)      # [E, 1, 2]
    return force + torch.cat([force_c_xy, torch.zeros_like(force_c_xy[..., :1])], dim=-1)


def prey_velocity(force: torch.Tensor, v_prey, componentwise: bool = True) -> torch.Tensor:
    """Velocity from the summed force.  ``componentwise=True`` reproduces the
    reference's per-component normalization (v = v_prey·sign(f) per axis)."""
    if componentwise:
        norm = torch.abs(force)
    else:
        norm = torch.linalg.vector_norm(force, dim=-1, keepdim=True)
    v = torch.as_tensor(v_prey, dtype=force.dtype, device=force.device)
    if v.dim() > 0:
        v = v.reshape(tuple(v.shape) + (1,) * (force.dim() - v.dim()))
    return v * force / (norm + 1e-5)
