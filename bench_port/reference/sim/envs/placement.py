"""Scene sampling on an occupancy grid with bounded iteration
(counterpart of mupe_tpu/envs/placement.py).

Free cells are drawn by Gumbel-top-k (uniform without replacement over the
free cells of every env at once); path feasibility is a fixed-iteration
4-neighbour flood fill.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.dist import EnvShard


class Grid(NamedTuple):
    """The arena occupancy grid: cells of 2·cylinder_size, centred on the
    origin."""

    num_grid: int
    grid_size: float
    boundary: float

    @property
    def center(self) -> int:
        return self.num_grid // 2


def make_grid(arena_size: float, cylinder_size: float) -> Grid:
    grid_size = 2.0 * cylinder_size
    num_grid = int(arena_size * 2.0 / grid_size)
    return Grid(num_grid=num_grid, grid_size=grid_size, boundary=arena_size - 0.1)


@functools.lru_cache(maxsize=None)
def _outside_circle_np(num_grid: int) -> np.ndarray:
    r = num_grid // 2
    i, j = np.meshgrid(np.arange(num_grid), np.arange(num_grid), indexing="ij")
    return np.sqrt((i - r) ** 2 + (j - r) ** 2) >= r


def outside_circle_mask(num_grid: int, device=None) -> torch.Tensor:
    """Cells at distance ≥ n//2 from the centre are outside the arena."""
    return torch.as_tensor(_outside_circle_np(num_grid), device=device)


def continuous_to_grid(coords: torch.Tensor, grid: Grid) -> torch.Tensor:
    """XY → integer cell indices (round half to even, as jnp.round)."""
    g = torch.round(coords / grid.grid_size).to(torch.int64) + grid.center
    return torch.clamp(g, 0, grid.num_grid - 1)


def grid_to_continuous(cells: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Integer cell indices → XY cell centres, clamped inside the boundary."""
    coords = (cells - grid.center).to(torch.float32) * grid.grid_size
    return torch.clamp(coords, -grid.boundary, grid.boundary)


def _cells_onehot(points_xy: torch.Tensor, grid: Grid) -> torch.Tensor:
    cells = continuous_to_grid(points_xy, grid)
    flat = cells[..., 0] * grid.num_grid + cells[..., 1]
    return F.one_hot(flat, grid.num_grid * grid.num_grid).bool()


def occupancy_from_points(points_xy: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Mark the cells containing `points_xy` [..., P, 2] → bool [..., G, G]."""
    occ = torch.any(_cells_onehot(points_xy, grid), dim=-2)
    return occ.reshape(tuple(occ.shape[:-1]) + (grid.num_grid, grid.num_grid))


def _draw(shard: Optional[EnvShard], sample, shape) -> torch.Tensor:
    """`sample(shape)`, or with a shard at the global arena count (axis 0)
    with this rank's rows kept."""
    return sample(tuple(shape)) if shard is None else shard.draw(sample, shape)


def sample_free_cells(
    gen: torch.Generator,
    occupied: torch.Tensor,  # bool [..., G, G]
    num_samples: int,
    grid: Grid,
    shard: Optional[EnvShard] = None,
) -> torch.Tensor:
    """Uniformly draw `num_samples` distinct free cells per env by
    Gumbel-top-k.  Returns XY coordinates [..., num_samples, 2].  With a
    `shard`, `occupied`'s leading axis holds this rank's arenas and the draw
    is made at the global count."""
    g2 = grid.num_grid * grid.num_grid
    occ_flat = occupied.reshape(tuple(occupied.shape[:-2]) + (g2,))
    u = _draw(shard, lambda s: torch.rand(s, generator=gen, device=occupied.device),
              occ_flat.shape)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    scores = torch.where(occ_flat, torch.full_like(gumbel, -float("inf")), gumbel)
    idx = torch.topk(scores, num_samples, dim=-1).indices          # [..., S]
    cells = torch.stack([idx // grid.num_grid, idx % grid.num_grid], dim=-1)
    return grid_to_continuous(cells, grid)


def sample_cylinders(
    gen: torch.Generator,
    drone_xy: torch.Tensor,    # [E, n, 2]
    target_xy: torch.Tensor,   # [E, 1, 2]
    grid: Grid,
    num_cylinders: int,
    min_active: int,
    max_active: int,
    fixed_active: Optional[int] = None,
    shard: Optional[EnvShard] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cylinders uniform over the cells free of the arena rim, the drones
    and the target; the active count uniform in [min_active, max_active]
    (or fixed).  Returns (xy [E, C, 2], active_count [E, 1]); a `shard`
    draws at the global arena count."""
    e = drone_xy.shape[0]
    dev = drone_xy.device
    occ = (
        outside_circle_mask(grid.num_grid, dev)[None]
        | occupancy_from_points(drone_xy, grid)
        | occupancy_from_points(target_xy, grid)
    )
    xy = sample_free_cells(gen, occ, num_cylinders, grid, shard)
    if fixed_active is not None:
        active = torch.full((e, 1), fixed_active, dtype=torch.int64, device=dev)
    else:
        active = _draw(shard, lambda s: torch.randint(min_active, max_active + 1, s,
                                                      generator=gen, device=dev), (e, 1))
    return xy, active


@functools.lru_cache(maxsize=None)
def _outside_window_np(num_grid: int, cl_bound: int) -> np.ndarray:
    c = num_grid // 2
    i, j = np.meshgrid(np.arange(num_grid), np.arange(num_grid), indexing="ij")
    inside = (
        (i >= c - cl_bound) & (i < c + cl_bound)
        & (j >= c - cl_bound) & (j < c + cl_bound)
    )
    return ~inside


def outside_window_mask(num_grid: int, cl_bound: int, device=None) -> torch.Tensor:
    """Cells outside the centred curriculum window of half-width `cl_bound`
    (placement.py:616-621: `grid_idx ~ randint(c − cl_bound, c + cl_bound)`).
    `cl_bound = num_grid // 2` disables the restriction."""
    return torch.as_tensor(_outside_window_np(num_grid, cl_bound), device=device)


def sample_spawns_cl(
    gen: torch.Generator,
    occupied: torch.Tensor,  # bool [..., G, G] already-occupied cells
    num_drones: int,
    grid: Grid,
    max_height: float,
    cl_bound: int = 6,
    height_bound: float = 0.5,
    shard: Optional[EnvShard] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Curriculum-bounded drone + target spawns (placement.py:560-646
    `generate_drone_target_large_after_cylinder`): distinct cells uniform
    over the free cells of the centred window of half-width `cl_bound`, z
    uniform in (H/2 − hb·H + 0.02, H/2 + hb·H − 0.02).  Returns
    (drone_pos [..., n, 3], target_pos [..., 1, 3]); a `shard` draws at the
    global arena count."""
    dev = occupied.device
    occ = occupied | outside_window_mask(grid.num_grid, cl_bound, dev)
    xy = sample_free_cells(gen, occ, num_drones + 1, grid, shard)
    lo = 0.5 * max_height - height_bound * max_height + 0.02
    hi = 0.5 * max_height + height_bound * max_height - 0.02
    u = _draw(shard, lambda s: torch.rand(s, generator=gen, device=dev),
              tuple(occupied.shape[:-2]) + (num_drones + 1, 1))
    pos = torch.cat([xy, lo + (hi - lo) * u], dim=-1)
    return pos[..., :num_drones, :], pos[..., num_drones:, :]


def flood_fill_reachable(
    free: torch.Tensor,    # bool [..., G, G] traversable cells
    start: torch.Tensor,   # int [..., 2] start cell
    num_iters: int,
) -> torch.Tensor:
    """Cells reachable from `start` by 4-neighbour moves through free cells;
    `num_iters` ≥ G²/2 guarantees convergence on a G×G grid."""
    g = free.shape[-1]
    start_flat = start[..., 0] * g + start[..., 1]
    reach = F.one_hot(start_flat, g * g).bool().reshape(free.shape) & free
    for _ in range(num_iters):
        grown = reach.clone()
        grown[..., :-1, :] |= reach[..., 1:, :]
        grown[..., 1:, :] |= reach[..., :-1, :]
        grown[..., :, :-1] |= reach[..., :, 1:]
        grown[..., :, 1:] |= reach[..., :, :-1]
        reach = grown & free
    return reach


def has_feasible_path(
    free: torch.Tensor, start: torch.Tensor, goals: torch.Tensor, num_iters: int
) -> torch.Tensor:
    """True per env iff every goal cell is reachable from start."""
    reach = flood_fill_reachable(free, start, num_iters)
    g = free.shape[-1]
    goals_flat = goals[..., 0] * g + goals[..., 1]
    reach_flat = reach.reshape(tuple(reach.shape[:-2]) + (g * g,))
    return torch.all(torch.gather(reach_flat, -1, goals_flat), dim=-1)


def active_cylinder_occupancy(
    cyl_xy: torch.Tensor,       # [..., C, 2]
    active_mask: torch.Tensor,  # bool [..., C]
    grid: Grid,
) -> torch.Tensor:
    """Occupancy grid of the active cylinders only → bool [..., G, G]."""
    onehot = _cells_onehot(cyl_xy, grid) & active_mask[..., None]
    occ = torch.any(onehot, dim=-2)
    return occ.reshape(tuple(occ.shape[:-1]) + (grid.num_grid, grid.num_grid))


def feasible_layout(
    drone_xy: torch.Tensor,     # [..., n, 2]
    target_xy: torch.Tensor,    # [..., 1, 2]
    cyl_xy: torch.Tensor,       # [..., C, 2]
    active_mask: torch.Tensor,  # bool [..., C]
    grid: Grid,
) -> torch.Tensor:
    """Per-env task validity: the target's cell and every drone's cell are
    free and connected through free cells.  Endpoints are first projected
    radially onto the grid circle (mupe_tpu/envs/placement.py:229-270), so a
    legal position near the arena rim is not mapped to an outside cell.
    Returns bool [...]."""
    free = ~(
        outside_circle_mask(grid.num_grid, cyl_xy.device)
        | active_cylinder_occupancy(cyl_xy, active_mask, grid)
    )
    r_in = (grid.num_grid // 2 - 0.55) * grid.grid_size

    def project(xy):
        r = torch.linalg.vector_norm(xy, dim=-1, keepdim=True)
        return xy * torch.clamp(r_in / torch.clamp(r, min=1e-6), max=1.0)

    start = continuous_to_grid(project(target_xy[..., 0, :]), grid)
    goals = continuous_to_grid(project(drone_xy), grid)          # [..., n, 2]
    g = grid.num_grid
    occ_flat = (~free).reshape(tuple(free.shape[:-2]) + (g * g,))
    pts = torch.cat([start[..., None, :], goals], dim=-2)
    pts_flat = pts[..., 0] * g + pts[..., 1]
    on_free = ~torch.any(torch.gather(occ_flat, -1, pts_flat), dim=-1)
    return on_free & has_feasible_path(free, start, goals, (g * g) // 2 + 1)


def largest_feasible_prefix(
    drone_xy: torch.Tensor,    # [E, n, 2]
    target_xy: torch.Tensor,   # [E, 1, 2]
    cyl_xy: torch.Tensor,      # [E, C, 2]
    active: torch.Tensor,      # [E, 1] int sampled cylinder count
    grid: Grid,
) -> torch.Tensor:
    """Largest c ≤ active such that the layout with only the first c
    cylinders is path-feasible (monotone in c; c = 0 is always feasible).
    All C+1 prefixes are checked in one batched flood fill.  Returns [E]."""
    c_max = cyl_xy.shape[-2]
    dev = cyl_xy.device
    cs = torch.arange(c_max + 1, device=dev)                        # [C+1]
    idx = torch.arange(c_max, device=dev)
    masks = idx[None, None, :] < torch.minimum(cs[:, None], active[:, 0][None, :])[..., None]
    k = c_max + 1
    prefix_ok = feasible_layout(
        drone_xy.expand((k,) + tuple(drone_xy.shape)),
        target_xy.expand((k,) + tuple(target_xy.shape)),
        cyl_xy.expand((k,) + tuple(cyl_xy.shape)),
        masks, grid,
    )                                                               # [C+1, E]
    ok = prefix_ok & (cs[:, None] <= active[:, 0][None, :])
    return torch.max(torch.where(ok, cs[:, None], torch.zeros_like(cs)[:, None]), dim=0).values
