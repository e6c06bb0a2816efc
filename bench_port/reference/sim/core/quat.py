"""Quaternion math (w, x, y, z convention) on torch tensors.

Counterpart of mupe_tpu/core/quat.py.  Every function broadcasts over
arbitrary leading batch dimensions.
"""
from __future__ import annotations

import torch


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of two (..., 4) wxyz quaternions."""
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """(w, -x, -y, -z): the bits of q * (1, -1, -1, -1), made on the device
    (no host tensor a call)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def _rotate_parts(q: torch.Tensor, v: torch.Tensor):
    q_w = q[..., :1]
    q_vec = q[..., 1:]
    q_vec, v = torch.broadcast_tensors(q_vec, v)
    a = v * (2.0 * q_w**2 - 1.0)
    b = torch.linalg.cross(q_vec, v, dim=-1) * q_w * 2.0
    c = q_vec * torch.sum(q_vec * v, dim=-1, keepdim=True) * 2.0
    return a, b, c


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v`` (..., 3) by quaternions ``q`` (..., 4)."""
    a, b, c = _rotate_parts(q, v)
    return a + b + c


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate ``v`` by the inverse of ``q`` (world→body for a body→world q)."""
    a, b, c = _rotate_parts(q, v)
    return a - b + c


def quat_axis(q: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """The world-frame direction of a body basis axis (0=x/heading, 2=z/up)."""
    basis = torch.zeros(3, dtype=q.dtype, device=q.device)
    basis[axis] = 1.0
    return quat_rotate(q, basis.expand(q.shape[:-1] + (3,)))


def euler_to_quaternion(rpy: torch.Tensor) -> torch.Tensor:
    """Roll-pitch-yaw (XYZ intrinsic) → wxyz quaternion."""
    r, p, y = rpy.unbind(-1)
    cy, sy = torch.cos(y * 0.5), torch.sin(y * 0.5)
    cp, sp = torch.cos(p * 0.5), torch.sin(p * 0.5)
    cr, sr = torch.cos(r * 0.5), torch.sin(r * 0.5)
    return torch.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        dim=-1,
    )


def quaternion_to_euler(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion → roll-pitch-yaw; the pitch is the arcsine of its
    argument clipped to [-1, 1]."""
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def quaternion_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion → (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    tx, ty, tz = 2.0 * x, 2.0 * y, 2.0 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    m = torch.stack(
        [
            1.0 - (tyy + tzz), txy - twz, txz + twy,
            txy + twz, 1.0 - (txx + tzz), tyz - twx,
            txz - twy, tyz + twx, 1.0 - (txx + tyy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def axis_angle_to_quaternion(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """`angle` (..., 1) about `axis` (..., 3) → wxyz quaternion."""
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    return torch.cat([torch.cos(angle / 2.0), torch.sin(angle / 2.0) * axis], dim=-1)


def quat_normalize(q: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + eps)


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt: float) -> torch.Tensor:
    """q(t+dt) = normalize(q + 0.5 · dt · [0, ω_w] ⊗ q)."""
    omega_quat = torch.cat([torch.zeros_like(omega_world[..., :1]), omega_world], dim=-1)
    dq = 0.5 * dt * quat_mul(omega_quat, q)
    return quat_normalize(q + dq)
