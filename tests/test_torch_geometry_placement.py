"""Arena geometry and scene placement of the PyTorch port against the JAX
package, plus property tests of the port's own sampler.

Geometry and the flood fill are comparisons and integer grid logic, so the
results must be equal (distances to float32 rounding, atol 1e-6).  The
samplers draw from different generators in the two packages, so the port's
sampler is held by the properties tests/test_placement.py checks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.envs import geometry as jgeo
from mupe_tpu.envs import placement as jpl
from mupe_tpu_torch.envs import geometry as tgeo
from mupe_tpu_torch.envs import placement as tpl
from mupe_tpu_torch.envs.hideandseek import HideAndSeek, HideAndSeekCfg

torch.set_num_threads(1)
GRID = tpl.make_grid(0.9, 0.1)
JGRID = jpl.make_grid(0.9, 0.1)


def _scene(rng, e=16, n=3, c=5):
    drone = rng.uniform(-0.7, 0.7, (e, n, 3)).astype(np.float32)
    target = rng.uniform(-0.7, 0.7, (e, 1, 3)).astype(np.float32)
    cyl = rng.uniform(-0.8, 0.8, (e, c, 3)).astype(np.float32)
    cyl[..., 2] = np.where(rng.uniform(size=(e, c)) < 0.3, -20.0, 0.6)
    return drone, target, cyl


def test_line_blocked_by_cylinder_matches_jax():
    rng = np.random.default_rng(0)
    drone, target, cyl = _scene(rng, e=64)
    j = jgeo.line_blocked_by_cylinder(jnp.asarray(drone), jnp.asarray(target),
                                      jnp.asarray(cyl), 0.1)
    t = tgeo.line_blocked_by_cylinder(torch.as_tensor(drone), torch.as_tensor(target),
                                      torch.as_tensor(cyl), 0.1)
    assert np.asarray(j).any() and not np.asarray(j).all()
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_k_nearest_cylinders_matches_jax():
    rng = np.random.default_rng(1)
    drone, _, cyl = _scene(rng, e=32)
    cyl[0, 1] = cyl[0, 0]  # a tie: broken by index in both packages
    j = jgeo.k_nearest_cylinders(jnp.asarray(drone), jnp.asarray(cyl), 0.1, 1.2, 3)
    t = tgeo.k_nearest_cylinders(torch.as_tensor(drone), torch.as_tensor(cyl), 0.1, 1.2, 3)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_flood_fill_matches_jax():
    rng = np.random.default_rng(2)
    free = rng.uniform(size=(12, 9, 9)) < 0.7
    start = rng.integers(0, 9, (12, 2))
    j = jpl.flood_fill_reachable(jnp.asarray(free), jnp.asarray(start), 41)
    t = tpl.flood_fill_reachable(torch.as_tensor(free), torch.as_tensor(start), 41)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_feasible_layout_and_prefix_match_jax():
    rng = np.random.default_rng(3)
    e = 48
    drone_xy = rng.uniform(-0.6, 0.6, (e, 3, 2)).astype(np.float32)
    target_xy = rng.uniform(-0.6, 0.6, (e, 1, 2)).astype(np.float32)
    # eval-table spawns near the rim exercise the endpoint projection
    drone_xy[:4] = [[0.6, 0.0], [0.8, 0.0], [0.8, -0.2]]
    cells = rng.integers(0, 9, (e, 5, 2))
    cyl_xy = ((cells - 4) * 0.2).astype(np.float32)
    active = rng.integers(0, 6, (e, 1))
    mask = np.arange(5)[None] < active
    j = jpl.feasible_layout(jnp.asarray(drone_xy), jnp.asarray(target_xy),
                            jnp.asarray(cyl_xy), jnp.asarray(mask), JGRID)
    t = tpl.feasible_layout(torch.as_tensor(drone_xy), torch.as_tensor(target_xy),
                            torch.as_tensor(cyl_xy), torch.as_tensor(mask), GRID)
    assert np.asarray(j).any() and not np.asarray(j).all()
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    jb = jpl.largest_feasible_prefix(jnp.asarray(drone_xy), jnp.asarray(target_xy),
                                     jnp.asarray(cyl_xy), jnp.asarray(active), JGRID)
    tb = tpl.largest_feasible_prefix(torch.as_tensor(drone_xy), torch.as_tensor(target_xy),
                                     torch.as_tensor(cyl_xy), torch.as_tensor(active), GRID)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_grid_helpers_match_jax():
    xy = np.random.default_rng(4).uniform(-1, 1, (50, 2)).astype(np.float32)
    xy[0] = [0.1, -0.3]  # exact half-cell: rounds half to even in both
    np.testing.assert_array_equal(
        tpl.continuous_to_grid(torch.as_tensor(xy), GRID).numpy(),
        np.asarray(jpl.continuous_to_grid(jnp.asarray(xy), JGRID)))
    np.testing.assert_array_equal(tpl.outside_circle_mask(9).numpy(),
                                  jpl.outside_circle_mask(9))


def test_sample_free_cells_distinct_and_free():
    occ = tpl.outside_circle_mask(9)[None].repeat(16, 1, 1)
    xy = tpl.sample_free_cells(torch.Generator().manual_seed(0), occ, 5, GRID)
    cells = tpl.continuous_to_grid(xy, GRID).numpy()
    m = tpl.outside_circle_mask(9).numpy()
    for e in range(16):
        assert len(np.unique(cells[e], axis=0)) == 5
        assert not m[cells[e, :, 0], cells[e, :, 1]].any()


def test_sample_cylinders_avoids_agents():
    drone_xy = torch.zeros((32, 3, 2))
    target_xy = torch.full((32, 1, 2), 0.2)
    xy, active = tpl.sample_cylinders(torch.Generator().manual_seed(3), drone_xy,
                                      target_xy, GRID, 5, 4, 5)
    cells = tpl.continuous_to_grid(xy, GRID).numpy()
    assert not (cells == [4, 4]).all(-1).any()
    assert not (cells == [5, 5]).all(-1).any()  # target at (0.2, 0.2)
    a = active.numpy()
    assert ((a >= 4) & (a <= 5)).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_sampled_scenes_are_free_disjoint_and_feasible(seed):
    env = HideAndSeek(HideAndSeekCfg(num_envs=64), device="cpu")
    drone, quat, target, cyl, fallback, degraded = env._sample_scene(
        torch.Generator().manual_seed(seed))
    active = cyl[..., 2] > 0
    cells = tpl.continuous_to_grid(cyl[..., :2], GRID)
    outside = tpl.outside_circle_mask(9).numpy()
    for e in range(64):
        act = cells[e][active[e]].numpy()
        assert len(np.unique(act, axis=0)) == len(act)          # no overlaps
        assert not outside[act[:, 0], act[:, 1]].any()          # inside the arena
    assert torch.all(tpl.feasible_layout(drone[..., :2], target[..., :2], cyl[..., :2],
                                         active, GRID))         # every env feasible
    assert torch.all((cyl[..., 2] == 0.6) | (cyl[..., 2] == -20.0))
    n_active = active.sum(-1)
    assert torch.all(n_active <= 5)
    assert torch.all((fallback == 0) | (n_active == 0))
    np.testing.assert_allclose(torch.linalg.vector_norm(quat, dim=-1).numpy(), 1.0, atol=1e-6)


def test_feasible_layout_projects_rim_endpoints():
    """Endpoints near the arena rim (x≈0.8) are projected onto the grid
    circle, so an empty arena is always feasible."""
    drone_xy = torch.tensor([[[0.6, 0.0], [0.8, 0.0], [0.8, -0.2]]])
    target_xy = torch.tensor([[[-0.8, 0.0]]])
    cyl_xy = torch.zeros((1, 5, 2))
    ok = tpl.feasible_layout(drone_xy, target_xy, cyl_xy, torch.zeros((1, 5), dtype=torch.bool),
                             GRID)
    assert bool(ok[0])
