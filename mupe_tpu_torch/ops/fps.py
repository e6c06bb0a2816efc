"""Farthest-point sampling (counterpart of mupe_tpu/ops/fps.py).

Greedy max-min selection over points [N, D]: keep each point's squared
distance to the nearest selected point and take the farthest, K times.
Invalid points carry -inf and are never chosen while a valid one is left;
ties go to the lowest index (argmax).  `farthest_point_sampling` runs the
plain PyTorch version on CPU tensors and the hand-written kernel in
`csrc/fps.cu` (all K rounds in one launch) on CUDA tensors.

Both sum a squared distance column by column in a fixed order,
d = (p0 - r0)^2, then d += (pj - rj)^2 for j = 1..D-1, each step rounded in
f32 (the kernel with `__fsub_rn` / `__fmul_rn` / `__fadd_rn`), so their
distances, and hence their indices, are the same bits.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build

# the kernel keeps the running min distance of every point in shared memory
_KERNEL_MAX_N = 48 * 1024
_KERNEL_MAX_D = 1024


def _start_tensor(start_index, device) -> torch.Tensor:
    """`start_index` (an int or a 0-d tensor, possibly on the device) as a
    one-element int64 tensor on `device`, without a host read."""
    return torch.as_tensor(start_index, device=device).reshape(1).to(torch.int64)


def reference_fps(
    points: torch.Tensor,
    k: int,
    valid: Optional[torch.Tensor] = None,
    start_index=0,
) -> torch.Tensor:
    """Indices [k] (int32) of a farthest-point subset: the plain version,
    the loop of mupe_tpu/ops/fps.py:19 with the kernel's order of sums."""
    n, d = points.shape
    dev = points.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    valid = valid.to(torch.bool)
    neg_inf = torch.full((n,), -float("inf"), dtype=points.dtype, device=dev)

    def dist_to(i):
        diff = points - points.index_select(0, i)
        sq = diff * diff
        acc = sq[:, 0]
        for j in range(1, d):
            acc = acc + sq[:, j]
        return torch.where(valid, acc, neg_inf)

    cur = _start_tensor(start_index, dev)
    selected = torch.empty((k,), dtype=torch.int64, device=dev)
    selected[0:1] = cur
    min_dist = dist_to(cur)
    for i in range(1, k):
        cur = torch.argmax(min_dist).reshape(1)
        selected[i : i + 1] = cur
        min_dist = torch.minimum(min_dist, dist_to(cur))
    return selected.to(torch.int32)


def _launch(points: torch.Tensor, k: int, valid: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    if points.device.type != "cuda":
        raise ValueError(f"FPS kernel takes CUDA tensors, got {points.device}")
    if points.dtype != torch.float32 or points.dim() != 2 or not points.is_contiguous():
        raise ValueError(f"points must be contiguous float32 [N, D], got {points.dtype} "
                         f"{tuple(points.shape)} contiguous={points.is_contiguous()}")
    n, d = points.shape
    if not (1 <= n <= _KERNEL_MAX_N and 1 <= d <= _KERNEL_MAX_D):
        raise ValueError(f"FPS kernel takes 1 <= N <= {_KERNEL_MAX_N}, 1 <= D <= "
                         f"{_KERNEL_MAX_D}, got [{n}, {d}]")
    if not 1 <= k <= n:
        raise ValueError(f"FPS kernel needs 1 <= k <= N, got k={k}, N={n}")
    if (valid.device != points.device or valid.dtype not in (torch.bool, torch.uint8)
            or tuple(valid.shape) != (n,) or not valid.is_contiguous()):
        raise ValueError(f"valid must be a contiguous bool/uint8 [{n}] on {points.device}, got "
                         f"{valid.dtype} {tuple(valid.shape)} on {valid.device}")
    start = start.to(torch.int32).contiguous()
    out = torch.empty((k,), dtype=torch.int32, device=points.device)
    cols = torch.empty((d, n), dtype=torch.float32, device=points.device)  # kernel scratch
    lib = build.library()
    with torch.cuda.device(points.device):
        err = lib.mupe_fps(
            points.data_ptr(), valid.data_ptr(), start.data_ptr(), n, d, k, cols.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(points.device).cuda_stream,
        )
    build.check(err, "mupe_fps")
    return out


def farthest_point_sampling(
    points: torch.Tensor,
    k: int,
    valid: Optional[torch.Tensor] = None,
    start_index=0,
) -> torch.Tensor:
    """Indices [k] (int32) of a farthest-point subset of `points` [N, D].
    `start_index` may be a 0-d tensor on the points' device (read there, not
    on the host).  CPU tensors: `reference_fps`; CUDA tensors: the kernel."""
    if points.device.type == "cpu":
        return reference_fps(points, k, valid, start_index)
    if valid is None:
        valid = torch.ones((points.shape[0],), dtype=torch.bool, device=points.device)
    out = _launch(points, k, valid, _start_tensor(start_index, points.device))
    farthest_point_sampling.launches += 1
    return out


farthest_point_sampling.launches = 0
