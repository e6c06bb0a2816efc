"""Arena geometry: line-of-sight blocking and k-nearest-cylinder gathers
(counterpart of mupe_tpu/envs/geometry.py)."""
from __future__ import annotations

from typing import Tuple

import torch


def line_blocked_by_cylinder(
    drone_pos: torch.Tensor,     # [E, n, 3]
    target_pos: torch.Tensor,    # [E, 1, 3]
    cylinder_pos: torch.Tensor,  # [E, C, 3]
    cylinder_size: float,
) -> torch.Tensor:
    """Whether any grounded cylinder blocks the drone↔target segment in XY:
    its XY distance to the supporting line ≤ radius, its foot of
    perpendicular within the segment, and it stands on the ground (z > 0).
    Returns bool [E, n]."""
    diff = drone_pos - target_pos                 # [E, n, 3]
    diff2 = cylinder_pos - target_pos             # [E, C, 3]
    num = torch.abs(
        diff[..., :, None, 0] * diff2[..., None, :, 1]
        - diff[..., :, None, 1] * diff2[..., None, :, 0]
    )                                             # [E, n, C]
    denom = torch.sqrt(
        torch.square(diff[..., :, None, 0]) + torch.square(diff[..., :, None, 1])
    )
    blocked = num / (denom + 1e-5) <= cylinder_size

    dx = target_pos[..., 0] - drone_pos[..., 0]   # [E, n]
    dy = target_pos[..., 1] - drone_pos[..., 1]
    num_t = (
        (cylinder_pos[..., None, :, 0] - drone_pos[..., :, None, 0]) * dx[..., :, None]
        + (cylinder_pos[..., None, :, 1] - drone_pos[..., :, None, 1]) * dy[..., :, None]
    )
    denom_t = torch.square(dx)[..., :, None] + torch.square(dy)[..., :, None]
    t = num_t / (denom_t + 1e-5)
    on_segment = (t >= 0.0) & (t <= 1.0)

    on_ground = (cylinder_pos[..., 2] > 0.0)[..., None, :]  # [E, 1, C]
    return torch.any(blocked & on_segment & on_ground, dim=-1)


def k_nearest_cylinders(
    drone_pos: torch.Tensor,     # [E, n, 3]
    cylinder_pos: torch.Tensor,  # [E, C, 3]
    cylinder_size: float,
    cylinder_height: float,
    k: int,
    mask_value: float = -5.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-drone k-nearest cylinder features → (masked [E, n, k, 5] with
    inactive → mask_value, raw [E, n, k, 5], invalid [E, n, k] bool).

    Ranks by pairwise comparison with ties broken by index (top_k's stable
    order), as the JAX package does."""
    e, n, _ = drone_pos.shape
    c = cylinder_pos.shape[1]
    rpos = cylinder_pos[:, None, :, :] - drone_pos[:, :, None, :]  # [E, n, C, 3]
    feat = torch.cat(
        [
            rpos,
            torch.full((e, n, c, 1), cylinder_height, dtype=drone_pos.dtype,
                       device=drone_pos.device),
            torch.full((e, n, c, 1), cylinder_size, dtype=drone_pos.dtype,
                       device=drone_pos.device),
        ],
        dim=-1,
    )
    inactive = cylinder_pos[..., 2] < 0.0                          # [E, C]
    mdist = torch.linalg.vector_norm(rpos, dim=-1) - cylinder_size  # [E, n, C]
    di = mdist[..., :, None]
    dj = mdist[..., None, :]
    idx = torch.arange(c, device=drone_pos.device)
    lt = (dj < di) | ((dj == di) & (idx[:, None] > idx[None, :]))
    rank = torch.sum(lt, dim=-1)                                   # [E, n, C]
    onehot = rank[..., None, :] == torch.arange(k, device=drone_pos.device)[:, None]
    sel = onehot.to(feat.dtype)                                    # [E, n, k, C]
    raw = sel @ feat                                               # [E, n, k, 5]
    invalid = torch.any(onehot & inactive[:, None, None, :], dim=-1)
    masked = torch.where(invalid[..., None], torch.full_like(raw, mask_value), raw)
    return masked, raw, invalid
