"""Reference trajectories and spatial sampling
(counterpart of mupe_tpu/utils/trajectory.py).

- lemniscate / circle / zigzag references for tracking tasks;
- B-spline evaluation (Cox–de Boor over a clamped knot vector);
- Poisson-disk spawn layouts by Mitchell's best candidate.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def lemniscate(t: torch.Tensor, c: float = 0.0) -> torch.Tensor:
    """The figure-eight (Bernoulli lemniscate in xy) with a vertical
    modulation c · sin(t) → [..., 3]."""
    sin_t, cos_t = torch.sin(t), torch.cos(t)
    denom = 1.0 + torch.square(sin_t)
    return torch.stack([cos_t / denom, sin_t * cos_t / denom, c * sin_t], dim=-1)


def circle(t: torch.Tensor, radius: float = 1.0, omega: float = 1.0) -> torch.Tensor:
    return torch.stack([radius * torch.cos(omega * t), radius * torch.sin(omega * t),
                        torch.zeros_like(t)], dim=-1)


def zigzag(t: torch.Tensor, period: float = 2.0, amplitude: float = 1.0) -> torch.Tensor:
    """A triangle wave across, advancing 0.2 a unit of t along x."""
    phase = (t / period) % 1.0
    tri = 2.0 * torch.abs(2.0 * phase - 1.0) - 1.0
    return torch.stack([t * 0.2, amplitude * tri, torch.zeros_like(t)], dim=-1)


def bspline_eval(control_points: torch.Tensor, knots: torch.Tensor, t: torch.Tensor,
                 degree: int = 3) -> torch.Tensor:
    """A clamped B-spline of `control_points` [K, D] over `knots`
    [K + degree + 1] at the parameters `t` [T] → [T, D] (the Cox–de Boor
    recursion; the last knot closes the last span)."""
    k = control_points.shape[0]
    tq = t[:, None]
    n = ((knots[:-1] <= tq) & (tq < knots[1:])).to(control_points.dtype)   # [T, M]
    last = torch.where(tq[:, 0] >= knots[-1], torch.ones_like(n[:, -1]), n[:, -1])
    n = torch.cat([n[:, :-1], last[:, None]], dim=1)
    for d in range(1, degree + 1):
        left_den = knots[d:-1] - knots[: -(d + 1)]
        right_den = knots[d + 1:] - knots[1:-d]
        left = torch.where(left_den > 1e-9, (tq - knots[: -(d + 1)]) / left_den,
                           torch.zeros((), dtype=n.dtype, device=n.device)) * n[:, :-1]
        right = torch.where(right_den > 1e-9, (knots[d + 1:] - tq) / right_den,
                            torch.zeros((), dtype=n.dtype, device=n.device)) * n[:, 1:]
        n = left + right
    return n[:, :k] @ control_points


def poisson_disk_sample(
    generator: Optional[torch.Generator],
    num_points: int,
    bounds: Tuple[float, float],
    min_dist: float,
    num_candidates: int = 30,
    first: Optional[torch.Tensor] = None,
    cand: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mitchell's best-candidate approximation of Poisson-disk sampling →
    [num_points, 2]: each new point is the one of `num_candidates` uniform
    candidates farthest from the points so far (the distance capped at
    2 · min_dist, the first candidate on a tie).  The uniforms in [lo, hi)
    come from `generator` on its device, or are given: `first` [2] and
    `cand` [num_points - 1, num_candidates, 2]."""
    lo, hi = bounds
    if first is None or cand is None:
        dev = generator.device

        def uniform(shape):
            return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev)

        first = uniform((2,)) if first is None else first
        cand = uniform((num_points - 1, num_candidates, 2)) if cand is None else cand
    pts = torch.zeros((num_points, 2), dtype=cand.dtype, device=cand.device)
    pts[0] = first
    index = torch.arange(num_points, device=cand.device)
    inf = torch.full((), float("inf"), dtype=cand.dtype, device=cand.device)
    for i in range(num_points - 1):
        c = cand[i]
        d = torch.linalg.vector_norm(c[:, None, :] - pts[None, :, :], dim=-1)   # [C, N]
        dmin = torch.amin(torch.where((index <= i)[None, :], d, inf), dim=-1)
        best = torch.argmax(torch.clamp(dmin, max=2.0 * min_dist))
        pts[i + 1] = c[best]
    return pts
