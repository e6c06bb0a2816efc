"""Adaptive Environment Generator (AEG) task buffer (counterpart of
mupe_tpu/envs/genbuffer.py).

A particle buffer of tasks of intermediate difficulty, as fixed-capacity
tensors with a valid count on the env's device.  A *task* is the flat vector
[drone_pos (n·3), target_pos (3), cylinder_pos (C·3)].

Every function that draws random numbers comes in two parts: `draw_*` takes
a `torch.Generator` and returns the draws, and the deterministic part takes
the draws (so a test can hand it the JAX package's).  `update_history`
branches on the host between its FPS and pack paths, once per closed cycle.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..ops.fps import farthest_point_sampling
from .placement import Grid, continuous_to_grid, feasible_layout, outside_circle_mask


@dataclasses.dataclass
class GenBufferState:
    """All AEG state as fixed-shape tensors."""

    history: torch.Tensor       # [L, task_dim] FPS-curated tasks
    history_len: torch.Tensor   # [] int32, valid prefix length
    eval_tasks: torch.Tensor    # [E, task_dim] tasks under evaluation
    weight_sum: torch.Tensor    # [E] accumulated success over eval episodes
    weight_count: torch.Tensor  # [] int32, episodes accumulated
    update_iter: torch.Tensor   # [] int32, episode counter mod eval_iter
    ratio_unif: torch.Tensor    # [] float, uniform-sampling mix ratio
    dry_cycles: torch.Tensor    # [] int32, consecutive cycles with num_added == 0

    @classmethod
    def create(
        cls, buffer_length: int, num_envs: int, task_dim: int, ratio_unif: float, device="cpu"
    ) -> "GenBufferState":
        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(
            history=zeros((buffer_length, task_dim)),
            history_len=zeros((), torch.int32),
            eval_tasks=zeros((num_envs, task_dim)),
            weight_sum=zeros((num_envs,)),
            weight_count=zeros((), torch.int32),
            update_iter=zeros((), torch.int32),
            ratio_unif=torch.tensor(ratio_unif, dtype=torch.float32, device=device),
            dry_cycles=zeros((), torch.int32),
        )


def draw_pick(gen: torch.Generator, gb: GenBufferState, num: int) -> torch.Tensor:
    """`num` indices uniform (with replacement) over the valid prefix, drawn
    on the device (no host read of `history_len`)."""
    u = torch.rand((num,), generator=gen, device=gb.history.device)
    n = torch.clamp(gb.history_len, min=1).to(torch.float32)
    return torch.minimum(torch.floor(u * n), n - 1).to(torch.int64)


def sample_history(gen: torch.Generator, gb: GenBufferState, num: int) -> torch.Tensor:
    """Uniformly sample `num` tasks (with replacement) from the valid prefix."""
    return gb.history[draw_pick(gen, gb, num)]


def draw_nearby(
    gen: torch.Generator, gb: GenBufferState, num: int, num_agents: int, num_cylinders: int,
    num_tries: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The draws of `sample_nearby`: pick indices [num], the drone/target
    noise in [-1, 1) [T, num, 3(n+1)] and the cylinder grid steps in {-1, 0, 1}
    [T, num, C, 2]."""
    dev = gb.history.device
    pick = draw_pick(gen, gb, num)
    dt_noise = torch.rand((num_tries, num, 3 * (num_agents + 1)), generator=gen,
                          device=dev) * 2.0 - 1.0
    cyl_steps = torch.randint(-1, 2, (num_tries, num, num_cylinders, 2), generator=gen,
                              device=dev)
    return pick, dt_noise, cyl_steps


def nearby_from_draws(
    gb: GenBufferState,
    pick: torch.Tensor,
    dt_noise: torch.Tensor,
    cyl_steps: torch.Tensor,
    grid: Grid,
    num_agents: int,
    num_cylinders: int,
    expand_step: float,
    expand_cylinders: bool,
    arena_size: float,
    max_height: float,
) -> torch.Tensor:
    """The deterministic part of `sample_nearby` (genbuffer.py:75-138): for
    each picked task, the first of the T noise draws whose entities all land
    on distinct free cells with a feasible layout wins; otherwise the
    unperturbed original."""
    origin = gb.history[pick]                                     # [num, D]
    num = origin.shape[0]
    num_tries = dt_noise.shape[0]
    dev, dt = origin.device, origin.dtype

    cylinder_boundary = int(arena_size / grid.grid_size) * grid.grid_size
    bxy = arena_size / np.sqrt(2.0) - 0.1
    lo_dt = np.tile([-bxy, -bxy, max_height - 0.1], num_agents + 1)
    hi_dt = np.tile([bxy, bxy, max_height + 0.1], num_agents + 1)
    lo_c = np.tile([-cylinder_boundary, -cylinder_boundary, -20.0], num_cylinders)
    hi_c = np.tile([cylinder_boundary, cylinder_boundary, max_height / 2], num_cylinders)
    lo = torch.as_tensor(np.concatenate([lo_dt, lo_c]), dtype=dt, device=dev)
    hi = torch.as_tensor(np.concatenate([hi_dt, hi_c]), dtype=dt, device=dev)

    dt_part = dt_noise.to(dt) * expand_step
    cyl_xy = cyl_steps.to(dt) * grid.grid_size
    if not expand_cylinders:
        cyl_xy = torch.zeros_like(cyl_xy)
    cyl_noise = torch.cat(
        [cyl_xy, torch.zeros((num_tries, num, num_cylinders, 1), dtype=dt, device=dev)], dim=-1
    ).reshape(num_tries, num, -1)
    noise = torch.cat([dt_part, cyl_noise], dim=-1)
    candidates = torch.clamp(origin[None] + noise, lo, hi)        # [T, num, D]

    ok = _sanity_check(candidates, grid, num_agents, num_cylinders)  # [T, num]
    any_ok = torch.any(ok, dim=0)
    first = torch.argmax(ok.to(torch.uint8), dim=0)               # first valid try
    chosen = torch.gather(
        candidates, 0, first[None, :, None].expand(1, num, candidates.shape[-1])
    )[0]
    return torch.where(any_ok[:, None], chosen, origin)


def sample_nearby(
    gen: torch.Generator,
    gb: GenBufferState,
    num: int,
    grid: Grid,
    num_agents: int,
    num_cylinders: int,
    expand_step: float,
    expand_cylinders: bool,
    arena_size: float,
    max_height: float,
    num_tries: int = 10,
) -> torch.Tensor:
    """Noise-expand `num` buffer tasks with a grid sanity check."""
    pick, dt_noise, cyl_steps = draw_nearby(gen, gb, num, num_agents, num_cylinders, num_tries)
    return nearby_from_draws(gb, pick, dt_noise, cyl_steps, grid, num_agents, num_cylinders,
                             expand_step, expand_cylinders, arena_size, max_height)


def _sanity_check(
    tasks: torch.Tensor, grid: Grid, num_agents: int, num_cylinders: int
) -> torch.Tensor:
    """All entities on distinct, inside-circle cells, and a feasible
    drone→target path (genbuffer.py:141-166).  tasks [..., D] → bool [...]."""
    pts = tasks.reshape(tuple(tasks.shape[:-1]) + (num_agents + 1 + num_cylinders, 3))
    cells = continuous_to_grid(pts[..., :2], grid)
    flat = cells[..., 0] * grid.num_grid + cells[..., 1]         # [..., P]
    outside = outside_circle_mask(grid.num_grid, tasks.device).reshape(-1)
    hits_outside = torch.any(outside[flat], dim=-1)
    p = flat.shape[-1]
    offdiag = ~torch.eye(p, dtype=torch.bool, device=tasks.device)
    dup = torch.any(((flat[..., :, None] == flat[..., None, :]) & offdiag).flatten(-2), dim=-1)
    n = num_agents
    cyl = pts[..., n + 1 :, :]
    feas = feasible_layout(pts[..., :n, :2], pts[..., n : n + 1, :2], cyl[..., :2],
                           cyl[..., 2] > 0.0, grid)
    return ~(hits_outside | dup) & feas


def insert_weights(gb: GenBufferState, success: torch.Tensor) -> GenBufferState:
    """Accumulate per-env success at an episode's end."""
    return dataclasses.replace(
        gb, weight_sum=gb.weight_sum + success, weight_count=gb.weight_count + 1
    )


def update_history(
    gb: GenBufferState, r_min: float, r_max: float, eps: float = 1e-5
) -> Tuple[GenBufferState, torch.Tensor]:
    """Close one eval cycle (genbuffer.py:177-224): tasks whose mean success
    lies in [r_min, r_max] join the history, farthest-point downsampled to
    capacity when the pool overflows it.  Returns (state, num_added).  The
    FPS/pack choice reads the pool size on the host (one sync a cycle)."""
    cap = gb.history.shape[0]
    dev = gb.history.device
    weights = gb.weight_sum / torch.clamp(gb.weight_count, min=1)
    keep = (weights >= r_min) & (weights <= r_max)                # [E]
    num_added = torch.sum(keep)
    pool = torch.cat([gb.history, gb.eval_tasks], dim=0)          # [cap+E, D]
    pool_valid = torch.cat([torch.arange(cap, device=dev) < gb.history_len, keep])
    total = gb.history_len + num_added

    if int(total) > cap:
        inf = torch.tensor(float("inf"), dtype=pool.dtype, device=dev)
        lo = torch.amin(torch.where(pool_valid[:, None], pool, inf), dim=0)
        hi = torch.amax(torch.where(pool_valid[:, None], pool, -inf), dim=0)
        norm = (pool - lo) / (hi - lo + eps)
        norm = torch.where(pool_valid[:, None], norm, torch.full_like(norm, 1e6))
        # start at the first valid point, as DGL's FPS starts at index 0
        start = torch.argmax(pool_valid.to(torch.uint8))
        idx = farthest_point_sampling(norm.contiguous(), cap, valid=pool_valid,
                                      start_index=start)
        history = pool[idx.to(torch.int64)]
        history_len = torch.full((), cap, dtype=torch.int32, device=dev)
    else:
        # fits without downsampling: stable-sort the valid entries to the front
        order = torch.argsort((~pool_valid).to(torch.uint8), stable=True)
        history = pool[order][:cap]
        history_len = torch.clamp(total, max=cap).to(torch.int32)
    gb = dataclasses.replace(
        gb,
        history=history,
        history_len=history_len,
        weight_sum=torch.zeros_like(gb.weight_sum),
        weight_count=torch.zeros_like(gb.weight_count),
    )
    return gb, num_added
