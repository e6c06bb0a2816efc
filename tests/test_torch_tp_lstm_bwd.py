"""The TP-LSTM backward of the port against the JAX package.

`reference_backward` (the kernel's plain version, [N, T, F] layout) is held
against the JAX package's `_tp_bwd_kernel_t` itself, run in Pallas interpret
mode through `_build_tp_calls_t` in its batch-in-lanes layout, at N = 96 and
97 windows of the main path's shapes (16 inputs, 10 steps, 15 outputs), and
at wider ones: 19 inputs (4 pursuers) with 18 outputs (6 predicted steps),
and 34 inputs (4 pursuers, obstacles) with 30 outputs (10 predicted steps),
20 steps each.  Both round dz and each step's gate cotangent to bf16 before the
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


def _case(n, seed, spec=SPEC):
    rng = np.random.default_rng(seed)
    leaves = [(rng.normal(size=s) / np.sqrt(s[0]) if len(s) == 2 else 0.1 * rng.normal(size=s))
              .astype(np.float32) for s in spec.leaf_shapes()]
    x = rng.normal(size=(n, spec.t_steps, spec.input_dim)).astype(np.float32)
    dy = rng.normal(size=(n, spec.out_dim)).astype(np.float32)
    return leaves, x, dy


@pytest.mark.parametrize("n,f,t,o", [pytest.param(96, 16, 10, 15, id="96"),
                                     pytest.param(97, 16, 10, 15, id="97"),
                                     pytest.param(96, 19, 20, 18, id="96-F19-T20-O18"),
                                     pytest.param(97, 34, 20, 30, id="97-F34-T20-O30")])
def test_reference_backward_matches_jax_tp_bwd_kernel(n, f, t, o):
    spec = tl.TPLSTMSpec(input_dim=f, hidden=64, t_steps=t, out_dim=o)
    leaves, x, dy = _case(n, n + f, spec) if f != 16 else _case(n, n)
    wi, wh, b, wfc, bfc = leaves
    op = -(-o // 8) * 8  # the output rows padded to a multiple of 8
    tleaves = (jnp.asarray(wi.T), jnp.asarray(wh.T), jnp.asarray(b[:, None]),
               jnp.asarray(np.concatenate([wfc.T, np.zeros((op - o, 64), np.float32)])),
               jnp.asarray(np.concatenate([bfc[:, None], np.zeros((op - o, 1), np.float32)])))
    xt = jnp.asarray(x.transpose(1, 2, 0).reshape(t * f, n))
    dyt = jnp.asarray(np.concatenate([dy.T, np.zeros((op - o, n), np.float32)]))
    _, bwd = _build_tp_calls_t(JSpec(input_dim=f, hidden=64, t_steps=t, out_dim=o), n, True)
    dwi, dwh, db, dwfc, dbfc = (np.array(g) for g in bwd(xt, dyt, *tleaves))
    want = [dwi.T, dwh.T, db[:, 0], dwfc[:o].T, dbfc[:o, 0]]
    got = tl.reference_backward(spec, [torch.as_tensor(l) for l in leaves], torch.as_tensor(x),
                                torch.as_tensor(dy))
    errs = PARITY_TOL.errors(got, [torch.as_tensor(w) for w in want])
    assert PARITY_TOL.holds(errs), errs
    if op > o:
        assert np.abs(dwfc[o:]).max() == 0.0  # the padded output rows add nothing


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
