"""The reference trajectories, B-spline evaluation and Poisson-disk spawns
of the PyTorch port against the JAX package, on the CPU.

The trajectories are elementwise float32 formulas: within 1e-6 of each
output's scale, max(1, its largest magnitude) (measured: at most 6.0e-8).
`bspline_eval` sums K basis products, within 1e-5 of the scale (measured:
1.1e-7), the last knot included.  `poisson_disk_sample` is fed JAX's own
uniforms (its keys split as JAX splits them) and picks the same candidate
each round: the points are equal (the distances round alike, and a tie
takes the first candidate on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.utils import trajectory as jt
from mupe_tpu_torch.utils import trajectory as tt

torch.set_num_threads(1)


def _held(t, j, rel):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    assert t.shape == j.shape
    assert float(np.abs(t - j).max()) <= rel * max(1.0, float(np.abs(j).max()))


@pytest.mark.parametrize("name, kw", [("lemniscate", {}), ("lemniscate", {"c": 0.3}),
                                      ("circle", {"radius": 2.0, "omega": 0.7}),
                                      ("zigzag", {}), ("zigzag", {"period": 1.3,
                                                                  "amplitude": 0.4})])
def test_references_match_jax(name, kw):
    t = np.random.default_rng(0).uniform(-20, 20, (5, 33)).astype(np.float32)
    _held(getattr(tt, name)(torch.as_tensor(t), **kw), getattr(jt, name)(jnp.asarray(t), **kw),
          1e-6)


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_bspline_matches_jax(degree):
    rng = np.random.default_rng(degree)
    k = 7
    inner = np.sort(rng.uniform(0.0, 1.0, k - degree - 1))
    knots = np.concatenate([np.zeros(degree + 1), inner, np.ones(degree + 1)]).astype(np.float32)
    cp = rng.normal(size=(k, 3)).astype(np.float32)
    # inside the spans, on a knot, and the last knot itself (the right edge)
    t = np.concatenate([rng.uniform(0, 1, 40), inner[:1], [0.0, 1.0]]).astype(np.float32)
    got = tt.bspline_eval(torch.as_tensor(cp), torch.as_tensor(knots), torch.as_tensor(t), degree)
    want = jt.bspline_eval(jnp.asarray(cp), jnp.asarray(knots), jnp.asarray(t), degree)
    _held(got, want, 1e-5)


def _jax_uniforms(key, num_points, bounds, num_candidates):
    """The uniforms `jt.poisson_disk_sample` draws from `key`."""
    lo, hi = bounds
    k0, krest = jax.random.split(key)
    first = jax.random.uniform(k0, (2,), minval=lo, maxval=hi)
    cand = jnp.stack([jax.random.uniform(k, (num_candidates, 2), minval=lo, maxval=hi)
                      for k in jax.random.split(krest, num_points - 1)])
    return np.array(first), np.array(cand)


@pytest.mark.parametrize("num_points, bounds, min_dist, c", [(12, (-1.0, 1.0), 0.3, 30),
                                                             (40, (0.0, 4.0), 0.5, 8),
                                                             (6, (-0.5, 0.5), 2.0, 5)])
def test_poisson_disk_matches_jax(num_points, bounds, min_dist, c):
    key = jax.random.PRNGKey(num_points)
    want = np.asarray(jt.poisson_disk_sample(key, num_points, bounds, min_dist, c))
    first, cand = _jax_uniforms(key, num_points, bounds, c)
    got = tt.poisson_disk_sample(None, num_points, bounds, min_dist, c,
                                 first=torch.as_tensor(first), cand=torch.as_tensor(cand))
    np.testing.assert_array_equal(got.numpy(), want)


def test_poisson_disk_from_a_generator_spreads_its_points():
    pts = tt.poisson_disk_sample(torch.Generator().manual_seed(0), 16, (-2.0, 2.0), 0.5)
    assert pts.shape == (16, 2) and bool(((pts >= -2.0) & (pts < 2.0)).all())
    d = torch.cdist(pts, pts) + torch.eye(16) * 10
    # best-candidate spacing: well above uniform's nearest neighbour
    assert float(d.min()) > 0.3
