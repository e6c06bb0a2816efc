"""Farthest-point sampling of the port against the JAX package.

The port's plain version (`reference_fps`, what the wrapper runs on CPU
tensors) against `mupe_tpu.ops.fps.farthest_point_sampling` and against the
Pallas kernel `_fps_kernel` run in interpret mode, on random-normal points:
the indices must be equal, index for index.  The distance sums run in
another order on the two sides, so equality holds where no two candidates
are within a rounding error of each other, as with these draws, or where
they are exact copies of one row (the tie case), whose sums are the same
bits in any one order: then the lower index must win on every side.
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
    """Points, valid mask, start and K of a case: N = 128 random-normal
    points for "plain", "mask" and "start"; "tie": N = 300 with the same far
    row at 40, 170 and 290 and another at 90 and 250, so that the lower
    index must win each tie (and the copies' minima then fall to 0);
    "few_valid": N = 300 with 9 valid points spread over the range and K =
    17, so the lowest valid index repeats once all are chosen."""
    rng = np.random.default_rng({"plain": 3, "mask": 4, "start": 5, "tie": 6, "few_valid": 7}[name])
    n = 300 if name in ("tie", "few_valid") else N
    pts = rng.normal(size=(n, D)).astype(np.float32)
    valid = None
    if name == "mask":
        valid = rng.random(n) < 0.6
    if name == "tie":
        pts[[40, 170, 290]] = 6.0
        pts[[90, 250]] = -5.0
    if name == "few_valid":
        valid = np.zeros(n, dtype=bool)
        valid[rng.choice(n, size=9, replace=False)] = True
    start = 37 if name == "start" else 0
    if valid is not None:
        start = int(np.argmax(valid))
    return pts, valid, start


@pytest.mark.parametrize("name", ["plain", "mask", "start", "tie", "few_valid"])
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
    idx = got.numpy()
    if valid is not None:
        assert valid[idx].all()
    if name == "tie":  # the lower index of each pair of copies, never a second copy
        assert 40 in idx and 90 in idx and not set(idx) & {170, 290, 250}
    if name == "few_valid":
        chosen = np.flatnonzero(valid)
        assert sorted(idx[:9]) == sorted(chosen) and (idx[9:] == chosen.min()).all()


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
