"""Farthest-point sampling (counterpart of mupe_tpu/ops/fps.py).

Greedy max-min selection over points [N, D]: keep each point's squared
distance to the nearest selected point and take the farthest, K times.
Invalid points carry -inf and are never chosen while a valid one is left;
ties go to the lowest index (argmax).  `farthest_point_sampling` runs the
plain PyTorch version on CPU tensors and the hand-written kernel in
`csrc/fps.cu` (all K rounds in one launch of one thread-block cluster) on
CUDA tensors.

The kernel splits the rows over the C blocks of a cluster (16 where the
card schedules such a cluster, else 8: `plan`).  `instance(n, d, c)` says
which of its instances runs: "resident" holds each block's ceil(N / C)
rows in its shared memory (padded to float4s, beside their running minima:
`resident_bytes`) while that fits the 227 KB a block can take, and
"registers" is that with each thread's two rows in its registers too
(D <= 32, ceil(N / C) <= 1,024: the AEG's pool); "streamed" holds as many
as fit in shared memory and reads the rest every round from a column-major
device scratch [D + 1, N].  At D = 27 the resident instance takes N up to
31,408 at C = 16 and 15,840 at C = 8.  `kernel_spec_ok` holds the kernel's
limits: N up to 2^20, D up to 1,024, 1 <= K <= N.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..utils import trace
from . import build

MAX_N = 1 << 20
MAX_D = 1024
CLUSTERS = (16, 8)        # blocks in the cluster, the first the card schedules
SMEM_MAX = 232_448        # bytes of shared memory one block can take on an H100
REG_QUADS, REG_THREADS = 8, 512  # the register instance: rows of <= 8 float4s, <= 512 threads
INSTANCES = ("streamed", "resident", "registers")  # the kernel's codes for them


def resident_bytes(n: int, d: int, c: int) -> int:
    """Shared memory of a block that holds all its ceil(N / C) rows
    (`csrc/fps.cu` `smem_floats`): two mbarriers, an inbox of 2 x C entries
    (value, index, two pad words, the row padded to float4s), the start row,
    2 x 32 warp winners, then the rows at a stride of 4 mod 8 floats and
    their running minima."""
    rows = -(-n // c)
    d4 = -(-d // 4) * 4
    stride = d4 if d4 % 8 else d4 + 4
    return 4 * (4 + 2 * c * (4 + d4) + d4 + 128 + rows * (stride + 1))


def instance(n: int, d: int, c: int) -> str:
    """The kernel instance for N points of width D in a cluster of C blocks:
    "registers" where every block's rows fit its shared memory, D <= 32 and
    R = ceil(N / C) <= 1,024 (each thread's two rows then live in its
    registers); "resident" where the rows fit the shared memory; "streamed"
    (as many as fit there, the rest read every round from a device scratch)
    past that."""
    if resident_bytes(n, d, c) > SMEM_MAX:
        return "streamed"
    return "registers" if d <= 4 * REG_QUADS and -(-n // c) <= 2 * REG_THREADS else "resident"


def kernel_spec_ok(n: int, d: int, k: int) -> bool:
    """Whether the kernel takes N points of width D and K rounds."""
    return 1 <= n <= MAX_N and 1 <= d <= MAX_D and 1 <= k <= n


def _check_spec(n: int, d: int, k: int) -> None:
    if not kernel_spec_ok(n, d, k):
        raise ValueError(f"FPS kernel takes 1 <= N <= {MAX_N}, 1 <= D <= {MAX_D} and "
                         f"1 <= k <= N, got N={n}, D={d}, k={k}")


@functools.lru_cache(maxsize=256)
def _clusters_fit(device: int, n: int, d: int, c: int) -> bool:
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        build.check(build.library().mupe_fps_clusters(
            n, d, c, INSTANCES.index(instance(n, d, c)), ctypes.byref(count)),
            "mupe_fps_clusters")
    return count.value >= 1


def plan(n: int, d: int, device) -> Tuple[int, str]:
    """(C, instance) that the kernel runs for N points of width D on the
    CUDA `device`: the first cluster size of `CLUSTERS` the card schedules."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    for c in CLUSTERS:
        if _clusters_fit(index, n, d, c):
            return c, instance(n, d, c)
    raise RuntimeError(f"FPS kernel: the card schedules no cluster of {CLUSTERS[-1]} blocks "
                       f"for N={n}, D={d}")


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
    _check_spec(n, d, k)
    if (valid.device != points.device or valid.dtype not in (torch.bool, torch.uint8)
            or tuple(valid.shape) != (n,) or not valid.is_contiguous()):
        raise ValueError(f"valid must be a contiguous bool/uint8 [{n}] on {points.device}, got "
                         f"{valid.dtype} {tuple(valid.shape)} on {valid.device}")
    start = start.to(torch.int32).contiguous()
    out = torch.empty((k,), dtype=torch.int32, device=points.device)
    c, inst = plan(n, d, points.device)
    cols = None  # the streamed instance's scratch: the points column-major, then the minima
    if inst == "streamed":
        cols = torch.empty((d + 1, n), dtype=torch.float32, device=points.device)
    lib = build.library()
    with torch.cuda.device(points.device):
        trace.launching()
        err = lib.mupe_fps(
            points.data_ptr(), valid.data_ptr(), start.data_ptr(), n, d, k, c,
            INSTANCES.index(inst), None if cols is None else cols.data_ptr(),
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
    with trace.span("kernel.fps"):
        return _launch(points, k, valid, _start_tensor(start_index, points.device))
