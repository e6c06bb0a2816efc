"""Analytic depth camera: a batched ray cast for drone-mounted views
(counterpart of mupe_tpu/sensors/depth.py; reference camera sensor,
omni_drones/sensors/camera.py:40-210).

The scene is analytic (the ground plane, the arena's cylindrical wall and
ceiling, obstacle cylinders, the target sphere), so each pixel's
distance_to_camera is the least positive root of closed-form ray-primitive
intersections, clipped to [min_range, max_range]; misses are inf before
the clip.  Plain elementwise torch over the batch and the pixel grid.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import quat_rotate

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class DepthCameraCfg:
    """Pinhole intrinsics (reference PinholeCameraCfg, sensors/config.py:
    88-120, at an RL size): the horizontal FOV is 2 atan(20.955 / 48)."""

    width: int = 64
    height: int = 48
    hfov: float = 2.0 * float(np.arctan(20.955 / (2.0 * 24.0)))
    max_range: float = 10.0
    min_range: float = 0.02


def pinhole_rays(cfg: DepthCameraCfg) -> np.ndarray:
    """Unit ray directions in the camera (= drone body) frame, [H, W, 3]
    float32: +x forward along the optical axis, +y left, +z up, through the
    pixel centres; computed in float64, then cast."""
    w, h = cfg.width, cfg.height
    tan_h = np.tan(cfg.hfov / 2.0)
    tan_v = tan_h * h / w
    ys = tan_h * (1.0 - (2.0 * np.arange(w) + 1.0) / w)
    zs = tan_v * (1.0 - (2.0 * np.arange(h) + 1.0) / h)
    yy, zz = np.meshgrid(ys, zs)
    dirs = np.stack([np.ones_like(yy), yy, zz], axis=-1)
    return (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)


def _inf_unless(valid: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, t, torch.full_like(t, INF))


def _ray_ground(o, d, z0: float):
    """Distance to the plane z = z0 (inf when parallel or behind)."""
    dz = d[..., 2]
    t = (z0 - o[..., 2]) / torch.where(torch.abs(dz) < 1e-9, torch.full_like(dz, 1e-9), dz)
    return _inf_unless(t > 0.0, t)


def _ray_cylinder_inner(o, d, radius: float):
    """Distance to the arena wall (an infinite cylinder about the z axis):
    the least positive root."""
    ox, oy, dx, dy = o[..., 0], o[..., 1], d[..., 0], d[..., 1]
    a = dx * dx + dy * dy
    b = 2.0 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - radius * radius
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    denom = torch.where(a < 1e-12, torch.full_like(a, 1e-12), 2.0 * a)
    t_near = (-b - sq) / denom
    t_far = (-b + sq) / denom
    t = torch.where(t_near > 0.0, t_near, t_far)
    return _inf_unless((disc >= 0.0) & (t > 0.0), t)


def _ray_cylinder_outer(o, d, centers, radius: float, z_top):
    """Distance to the nearest obstacle cylinder hit from outside: o, d
    [..., 3], centers [..., C, 3] (z < 0 parks a cylinder), z_top the tops'
    height; the near root whose hit lies within [0, z_top]."""
    rel = o[..., None, :2] - centers[..., :2]
    dx, dy = d[..., None, 0], d[..., None, 1]
    a = dx * dx + dy * dy
    b = 2.0 * (rel[..., 0] * dx + rel[..., 1] * dy)
    c = rel[..., 0] ** 2 + rel[..., 1] ** 2 - radius * radius
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = (-b - sq) / torch.where(a < 1e-12, torch.full_like(a, 1e-12), 2.0 * a)
    zhit = o[..., None, 2] + t * d[..., None, 2]
    valid = ((disc >= 0.0) & (t > 0.0) & (centers[..., 2] >= 0.0) & (zhit >= 0.0)
             & (zhit <= z_top))
    return torch.amin(_inf_unless(valid, t), dim=-1)


def _ray_sphere(o, d, center, radius: float):
    """Distance to a sphere (the target), near root."""
    rel = o - center
    b = 2.0 * torch.sum(rel * d, dim=-1)
    c = torch.sum(rel * rel, dim=-1) - radius * radius
    disc = b * b - 4.0 * c
    t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / 2.0
    return _inf_unless((disc >= 0.0) & (t > 0.0), t)


def depth_image(
    cfg: DepthCameraCfg,
    cam_pos: torch.Tensor,                      # [..., 3]
    cam_quat: torch.Tensor,                     # [..., 4] wxyz body -> world
    cylinders: Optional[torch.Tensor] = None,   # [..., C, 3]
    cylinder_size: float = 0.1,
    arena_size: Optional[float] = None,
    max_height: Optional[float] = None,
    target_pos: Optional[torch.Tensor] = None,  # [..., 3]
    target_radius: float = 0.05,
    rays: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[..., H, W] depth (distance_to_camera) for batched cameras: the
    ground, the ceiling at `max_height`, the wall at `arena_size`, the
    obstacle cylinders up to `max_height` and the target sphere, each where
    given."""
    if rays is None:
        rays = torch.from_numpy(pinhole_rays(cfg)).to(cam_pos.device)
    batch = tuple(cam_pos.shape[:-1])
    d_world = quat_rotate(cam_quat[..., None, :], rays.reshape((1,) * len(batch) + (-1, 3)))
    o = cam_pos[..., None, :]
    t = _ray_ground(o, d_world, 0.0)
    if max_height is not None:
        t = torch.minimum(t, _ray_ground(o, d_world, max_height))
    if arena_size is not None:
        t = torch.minimum(t, _ray_cylinder_inner(o, d_world, arena_size))
    if cylinders is not None:
        z_top = max_height if max_height is not None else INF
        t = torch.minimum(t, _ray_cylinder_outer(o, d_world, cylinders[..., None, :, :],
                                                 cylinder_size, z_top))
    if target_pos is not None:
        t = torch.minimum(t, _ray_sphere(o, d_world, target_pos[..., None, :], target_radius))
    return torch.clamp(t, cfg.min_range, cfg.max_range).reshape(batch + (cfg.height, cfg.width))
