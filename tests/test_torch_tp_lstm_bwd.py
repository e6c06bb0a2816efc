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

The card's backward runs in two stages; their plain versions
(`reference_backward_operands`, the staged bf16 operands of the weight
products and the bias sums, then `reference_weight_grads`, those products)
are held to `reference_backward` (the same values summed in another order:
`WEIGHT_GRAD_TOL`) and to the JAX kernel with the same limits as above.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.ops.tp_lstm import TPLSTMSpec as JSpec
from mupe_tpu.ops.tp_lstm import _build_tp_calls_t
from mupe_tpu_torch.ops import fused_encoder as fe
from mupe_tpu_torch.ops import tp_lstm as tl
from mupe_tpu_torch.ops.tolerance import GradTol, in_f64

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


CASES = [pytest.param(96, 16, 10, 15, id="96"),
         pytest.param(97, 16, 10, 15, id="97"),
         pytest.param(96, 19, 20, 18, id="96-F19-T20-O18"),
         pytest.param(97, 34, 20, 30, id="97-F34-T20-O30")]


def _two_stages(spec, leaves, x, dy):
    """The plain stage A's staged operands through the plain stage B."""
    staged, sums = tl.reference_backward_operands(spec, leaves, x, dy)
    both = {**sums, **tl.reference_weight_grads(spec, staged)}
    return [both[i] for i in range(5)]


@pytest.mark.parametrize("n,f,t,o", CASES)
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
    staged = _two_stages(spec, [torch.as_tensor(l) for l in leaves], torch.as_tensor(x),
                         torch.as_tensor(dy))
    errs = PARITY_TOL.errors(staged, [torch.as_tensor(w) for w in want])
    assert PARITY_TOL.holds(errs), errs


@pytest.mark.parametrize("n,f,t,o", CASES + [pytest.param(5, 7, 1, 3, id="5-F7-T1-O3")])
def test_the_two_plain_stages_compose_to_reference_backward(n, f, t, o):
    """Stage A's staged operands, passed through stage B, give
    `reference_backward`'s gradients: the bias sums equal, the weight
    products the same bf16 values summed in another order.  The staged
    operands are bf16 values of the shapes stage B takes."""
    spec = tl.TPLSTMSpec(input_dim=f, hidden=64, t_steps=t, out_dim=o)
    leaves, x, dy = _case(n, 7 * n + f, spec)
    leaves = [torch.as_tensor(l) for l in leaves]
    x, dy = torch.as_tensor(x), torch.as_tensor(dy)
    ref = tl.reference_backward(spec, leaves, x, dy)
    got = _two_stages(spec, leaves, x, dy)
    assert torch.equal(got[2], ref[2]) and torch.equal(got[4], ref[4])
    if t > 1:
        assert fe.WEIGHT_GRAD_TOL.holds(fe.WEIGHT_GRAD_TOL.errors(got, ref))
    else:  # one step: h_0 = 0, so wh gets no gradient
        assert not got[1].any() and not ref[1].any()
    staged, _ = tl.reference_backward_operands(spec, leaves, x, dy)
    shapes = {"x": (t, n, f), "h": (t, n, 64), "dg": (t, n, 256), "dz": (n, o)}
    for k, v in staged.items():
        assert tuple(v.shape) == shapes[k] and torch.equal(v, v.bfloat16().float()), k


def test_backward_tolerance_rejects_the_f32_control():
    """`BWD_KERNEL_TOL` rejects the plain backward without its bf16 rounding
    at N = 300 on every leaf but those of `BWD_CONTROL_BLIND` (the output
    bias, whose gradient meets no rounding point but y), with its limits as
    the card holds them (raised to FLOOR_MULT times the f32 plain version's
    error against the plain version in f64) and without; and accepts the
    plain backward with its sums in another order, and the two plain stages."""
    leaves, x, dy = _case(300, 300)
    leaves, x, dy = [torch.as_tensor(l) for l in leaves], torch.as_tensor(x), torch.as_tensor(dy)
    ref = tl.reference_backward(SPEC, leaves, x, dy)
    exact = in_f64(tl.reference_backward, SPEC, leaves, x, dy)
    tol = tl.BWD_KERNEL_TOL
    control = tl.reference_backward(SPEC, leaves, x, dy, bf16=False)
    for ex in (None, exact):
        bad = tol.failing(tol.errors(control, ref, ex))
        assert set(bad) >= set(range(5)) - {i % 5 for i in tl.BWD_CONTROL_BLIND}, bad
    split = [u + v for u, v in zip(tl.reference_backward(SPEC, leaves, x[:100], dy[:100]),
                                   tl.reference_backward(SPEC, leaves, x[100:], dy[100:]))]
    assert tol.holds(tol.errors(split, ref)) and tol.holds(tol.errors(split, ref, exact))
    assert tol.holds(tol.errors(_two_stages(SPEC, leaves, x, dy), ref, exact))
