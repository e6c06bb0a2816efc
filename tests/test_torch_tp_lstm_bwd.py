"""The TP-LSTM backward of the port against the JAX package.

`reference_backward` (the kernel's plain version, [N, T, F] layout) is held
against the JAX package's `_tp_bwd_kernel_t` itself, run in Pallas interpret
mode through `_build_tp_calls_t` in its batch-in-lanes layout, at N = 96 and
97 windows.  Both round dz and each step's gate cotangent to bf16 before the
products and sum in f32 in another order: per gradient leaf, the largest
error is held to 1e-2 of that leaf's largest magnitude and the mean error to
1e-3 of its mean magnitude (measured up to 2.5e-4 and 6.5e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.ops.tp_lstm import TPLSTMSpec as JSpec
from mupe_tpu.ops.tp_lstm import _build_tp_calls_t
from mupe_tpu_torch.ops import tp_lstm as tl
from mupe_tpu_torch.ops.tolerance import GradTol

torch.set_num_threads(1)
SPEC = tl.TPLSTMSpec(input_dim=16, hidden=64, t_steps=10, out_dim=15)
PARITY_TOL = GradTol(max_rel=1e-2, mean_rel=1e-3)


def _case(n, seed):
    rng = np.random.default_rng(seed)
    leaves = [(rng.normal(size=s) / np.sqrt(s[0]) if len(s) == 2 else 0.1 * rng.normal(size=s))
              .astype(np.float32) for s in SPEC.leaf_shapes()]
    x = rng.normal(size=(n, 10, 16)).astype(np.float32)
    dy = rng.normal(size=(n, 15)).astype(np.float32)
    return leaves, x, dy


@pytest.mark.parametrize("n", [96, 97])
def test_reference_backward_matches_jax_tp_bwd_kernel(n):
    leaves, x, dy = _case(n, n)
    wi, wh, b, wfc, bfc = leaves
    op = 16  # the output rows padded to a multiple of 8
    tleaves = (jnp.asarray(wi.T), jnp.asarray(wh.T), jnp.asarray(b[:, None]),
               jnp.asarray(np.concatenate([wfc.T, np.zeros((op - 15, 64), np.float32)])),
               jnp.asarray(np.concatenate([bfc[:, None], np.zeros((op - 15, 1), np.float32)])))
    xt = jnp.asarray(x.transpose(1, 2, 0).reshape(160, n))
    dyt = jnp.asarray(np.concatenate([dy.T, np.zeros((op - 15, n), np.float32)]))
    _, bwd = _build_tp_calls_t(JSpec(input_dim=16, hidden=64, t_steps=10, out_dim=15), n, True)
    dwi, dwh, db, dwfc, dbfc = (np.array(g) for g in bwd(xt, dyt, *tleaves))
    want = [dwi.T, dwh.T, db[:, 0], dwfc[:15].T, dbfc[:15, 0]]
    got = tl.reference_backward(SPEC, [torch.as_tensor(l) for l in leaves], torch.as_tensor(x),
                                torch.as_tensor(dy))
    errs = PARITY_TOL.errors(got, [torch.as_tensor(w) for w in want])
    assert PARITY_TOL.holds(errs), errs
    assert np.abs(dwfc[15:]).max() == 0.0  # the padded output row adds nothing


def test_backward_tolerance_rejects_the_f32_control():
    """`BWD_KERNEL_TOL` rejects the plain backward without its bf16 rounding
    at N = 300 on every leaf but those of `BWD_CONTROL_BLIND` (the output
    bias, whose gradient meets no rounding point but y), and accepts the
    plain backward with its sums in another order."""
    leaves, x, dy = _case(300, 300)
    leaves, x, dy = [torch.as_tensor(l) for l in leaves], torch.as_tensor(x), torch.as_tensor(dy)
    ref = tl.reference_backward(SPEC, leaves, x, dy)
    tol = tl.BWD_KERNEL_TOL
    bad = tol.failing(tol.errors(tl.reference_backward(SPEC, leaves, x, dy, bf16=False), ref))
    assert set(bad) >= set(range(5)) - {i % 5 for i in tl.BWD_CONTROL_BLIND}, bad
    split = [u + v for u, v in zip(tl.reference_backward(SPEC, leaves, x[:100], dy[:100]),
                                   tl.reference_backward(SPEC, leaves, x[100:], dy[100:]))]
    assert tol.holds(tol.errors(split, ref))
