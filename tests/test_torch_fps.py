"""Farthest-point sampling of the port against the JAX package.

The port's plain version (`reference_fps`, what the wrapper runs on CPU
tensors) against `mupe_tpu.ops.fps.farthest_point_sampling` and against the
Pallas kernel `_fps_kernel` run in interpret mode, on random-normal points:
the indices must be equal, index for index.  The distance sums run in
another order on the two sides, so equality holds where no two candidates
are within a rounding error of each other, as with these draws.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.ops.fps import farthest_point_sampling as jfps
from mupe_tpu_torch.ops.fps import farthest_point_sampling, reference_fps

N, D, K = 128, 16, 17


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The Pallas FPS kernel in interpret mode (tests/test_native_and_ops.py)."""
    from jax.experimental import pallas as pl

    import mupe_tpu.ops.fps_pallas as fpsp

    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)
    return fpsp.farthest_point_sampling_pallas.__wrapped__


def _case(name):
    rng = np.random.default_rng({"plain": 3, "mask": 4, "start": 5}[name])
    pts = rng.normal(size=(N, D)).astype(np.float32)
    valid = rng.random(N) < 0.6 if name == "mask" else None
    start = 37 if name == "start" else 0
    return pts, valid, start


@pytest.mark.parametrize("name", ["plain", "mask", "start"])
def test_plain_fps_matches_jax(name, pallas_interpret):
    pts, valid, start = _case(name)
    jvalid = None if valid is None else jnp.asarray(valid)
    want = np.asarray(jfps(jnp.asarray(pts), K, valid=jvalid, start_index=start))
    want_pallas = np.asarray(pallas_interpret(jnp.asarray(pts), K, valid=jvalid,
                                              start_index=start))
    tvalid = None if valid is None else torch.as_tensor(valid)
    got = farthest_point_sampling(torch.as_tensor(pts), K, valid=tvalid, start_index=start)
    assert got.dtype == torch.int32 and tuple(got.shape) == (K,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want_pallas)
    if valid is not None:
        assert valid[got.numpy()].all()


def test_start_index_as_a_tensor():
    pts, _, _ = _case("plain")
    t = torch.as_tensor(pts)
    np.testing.assert_array_equal(reference_fps(t, K, start_index=torch.tensor(9)).numpy(),
                                  reference_fps(t, K, start_index=9).numpy())
    assert int(reference_fps(t, K, start_index=torch.tensor(9))[0]) == 9


def test_fewer_valid_points_than_k_repeats_the_lowest_index():
    """Once every valid point is chosen their distances are 0: argmax takes
    the lowest index, and invalid points are still never chosen."""
    pts = torch.as_tensor(np.random.default_rng(6).normal(size=(12, 3)).astype(np.float32))
    valid = torch.zeros(12, dtype=torch.bool)
    valid[[2, 5, 7]] = True
    idx = reference_fps(pts, 6, valid, start_index=2).tolist()
    assert sorted(idx[:3]) == [2, 5, 7] and idx[3:] == [2, 2, 2]
    want = np.asarray(jfps(jnp.asarray(pts.numpy()), 6, valid=jnp.asarray(valid.numpy()),
                           start_index=2))
    np.testing.assert_array_equal(np.asarray(idx), want)
