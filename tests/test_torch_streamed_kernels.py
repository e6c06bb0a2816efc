"""The encoder kernels past their tile instances, the forward + loss kernel on
the tensor-core tile, and the TP kernels past their register instances.

Specs of more than 16 tokens or 160 columns, or with a group wider than 128
features, run the streamed instance of every encoder kernel (an embed launch,
then the tile a chunk of 8 tokens at a time); TP shapes of more than 64
inputs or 64 outputs run the TP tile's generic instance.  The kernel tests
(marker `gpu`) skip without a CUDA card; run them on one with
`python -m pytest tests/test_torch_streamed_kernels.py -m gpu --noconftest`.
Limits are the modules' own (`KERNEL_TOL`, `BWD_KERNEL_TOL`, the loss
kernels' `loss_row_tols`), floor-relative with the plain version in f64
given; below 300 rows the backward's mean limit is 5e-3 and the streamed
forward is held as a per-row output (`loss_row_tols`), as chip_smoke.py
holds them.  The CPU tests check which instance each spec takes.
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest
import torch

import mupe_tpu_torch
from mupe_tpu_torch.ops import fused_encoder as fe
from mupe_tpu_torch.ops import tp_lstm as tl
from mupe_tpu_torch.ops.tolerance import in_f64

PKG = Path(mupe_tpu_torch.__file__).resolve().parent
MAIN_GROUPS = ((1, 35), (3, 5), (2, 3))
# 17 tokens (num_agents=6, obs_max_cylinder=11), 28 tokens over 261 columns
# with state_self 140 wide (num_agents=8, obs_max_cylinder=20,
# future_prediction_step=40), and 300 columns in one 300-wide group.
STREAMED = {"17 tokens": ((1, 35), (11, 5), (5, 3)),
            "28 tokens, 261 columns": ((1, 140), (20, 5), (7, 3)),
            "300 columns": ((1, 300), (2, 5))}
WIDE_TP = (91, 40, 120)


def _leaves(shapes, gen, device="cpu"):
    return [
        (torch.randn(s, generator=gen) / math.sqrt(s[0]) if len(s) == 2
         else 0.1 * torch.randn(s, generator=gen)).to(device)
        for s in shapes
    ]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", PKG.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _pair(groups, gen, device):
    spec_a = fe.EncoderSpec(groups=groups, head_dim=4)
    spec_c = fe.EncoderSpec(groups=groups, head_dim=1)
    return (spec_a, spec_c, _leaves(fe.leaf_shapes(spec_a), gen, device),
            _leaves(fe.leaf_shapes(spec_c), gen, device))


@pytest.mark.parametrize("groups", list(STREAMED), ids=list(STREAMED))
def test_streamed_specs_are_taken_past_the_tile_instances(groups):
    spec = fe.EncoderSpec(groups=STREAMED[groups], head_dim=4)
    assert fe.kernel_spec_ok(spec) and not fe.tile_spec_ok(spec)
    assert fe.tile_spec_ok(fe.EncoderSpec(groups=MAIN_GROUPS, head_dim=4))
    assert fe.tile_spec_ok(fe.EncoderSpec(groups=((1, 83), (10, 5), (5, 3)), head_dim=4))


def test_wide_tp_shape_takes_the_generic_instance():
    spec = tl.TPLSTMSpec(input_dim=WIDE_TP[0], hidden=64, t_steps=WIDE_TP[1], out_dim=WIDE_TP[2])
    assert tl.kernel_spec_ok(spec) and not tl.register_spec_ok(spec)
    assert tl.register_spec_ok(tl.TPLSTMSpec(input_dim=64, hidden=64, t_steps=40, out_dim=64))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only on the GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(out, ref, tol, exact=None):
    errs = tol.errors(out, ref, exact)
    assert tol.holds(errs), errs


def _bwd_close(outs, refs, tol, exact=None):
    errs = tol.errors(outs, refs, exact)
    assert tol.holds(errs), [(i, errs[i]) for i in tol.failing(errs)]


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 7, 8, 9, 17, 4099])
@pytest.mark.parametrize("groups", list(STREAMED), ids=list(STREAMED))
def test_streamed_kernels_match_plain_version(cuda, groups, s):
    """The pair forward, the pair backward and both loss kernels past the
    tile instances, at the 8-row tile's edges: within their limits of the
    plain versions, every row counted (dbh == S), the fwdloss kernel's mean
    and value the pair forward's bits."""
    g = torch.Generator().manual_seed(s)
    spec_a, spec_c, la, lc = _pair(STREAMED[groups], g, cuda)
    x = (2.0 * torch.randn((s, spec_a.obs_dim), generator=g)).to(cuda)
    a, c = fe.encoder_pair_forward(spec_a, spec_c, la, lc, x)
    # below SMALL_S_ROWS the mean error is one row's: one bf16 flip at 28
    # tokens moves it past 1e-4 at a draw whose floor is 0, so the forward is
    # held as the loss kernels' per-row outputs are (`loss_row_tols`)
    ftol = fe.loss_row_tols(s)[0]
    _close(a, fe.reference_apply(spec_a, la, x), ftol, in_f64(fe.reference_apply, spec_a, la, x))
    _close(c, fe.reference_apply(spec_c, lc, x), ftol, in_f64(fe.reference_apply, spec_c, lc, x))
    da = torch.randn((s, 4), generator=g).to(cuda)
    ones = torch.ones((s, 1), device=cuda)
    tol = fe.BWD_KERNEL_TOL if s >= 300 else dataclasses.replace(fe.BWD_KERNEL_TOL, mean_rel=5e-3)
    ga, gc = fe.encoder_backward([(spec_a, la), (spec_c, lc)], x, [da, ones])
    again = fe.encoder_backward([(spec_a, la), (spec_c, lc)], x, [da, ones])
    _bwd_close(ga, fe.reference_backward(spec_a, la, x, da), tol,
               in_f64(fe.reference_backward, spec_a, la, x, da))
    _bwd_close(gc, fe.reference_backward(spec_c, lc, x, ones), tol,
               in_f64(fe.reference_backward, spec_c, lc, x, ones))
    assert gc[-1].item() == float(s)
    assert all(torch.equal(u, v) for u, v in zip((*ga, *gc), (*again[0], *again[1])))
    loss, rows = _chip_smoke().loss_inputs(spec_a, spec_c, la, lc, x, g)
    args = (spec_a, spec_c, loss, la, lc, *rows)
    rows_tol, stats_tol = fe.loss_row_tols(s)
    ref = fe.reference_pair_fwd_loss(*args)
    exact = in_f64(fe.reference_pair_fwd_loss, *args)
    out9 = fe.pair_forward_loss(*args)
    out10 = fe.pair_forward_loss_agrad(*args)
    for got, want, ex in zip((*out9[:3], *out10[:2]), (*ref[:3], *ref[1:3]),
                             (*exact[:3], *exact[1:3])):
        _close(got, want, rows_tol, ex)
    for st in (out9[3], out10[2]):
        for col in range(st.shape[1]):
            _close(st[:, col], ref[3][:, col], stats_tol, exact[3][:, col])
    _bwd_close(out10[3], fe.reference_backward(spec_a, la, x, ref[0]), tol,
               in_f64(fe.reference_pair_fwd_loss_agrad, *args)[3])
    _forward_bits(args, out9, out10)


def _forward_bits(args, out9, out10):
    """Kernel 9's dv1, dv2 and stats are the agrad kernel's bits, and its
    dmu and dv1 those of the pair forward's mean and value through the plain
    loss math."""
    spec_a, spec_c, loss, la, lc, log_std, x, act, logp_old, adv, v_old, ret = args
    assert all(torch.equal(u, v) for u, v in zip(out9[1:], out10[:3]))
    mean, vout = fe.encoder_pair_forward(spec_a, spec_c, la, lc, x)
    plain = fe.reference_loss_math(loss, mean, vout, act, logp_old, adv, v_old, ret, log_std)
    assert torch.equal(plain[1], out9[1])
    s = x.shape[0]
    # dmu through `_loss_math`'s f32 forms on the same mean: within a few ulps
    torch.testing.assert_close(plain[0], out9[0], rtol=1e-5, atol=1e-6 / s)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 7, 8, 49152, 49153])
def test_fwdloss_kernel_on_the_tile_matches_plain_version_and_agrad_bits(cuda, s):
    """Kernel 9 at the main spec: within its limits of the plain version,
    its dv1, dv2 and stats bit-identical to the agrad kernel's, its value's
    dv1 to the pair forward's through the plain loss math."""
    g = torch.Generator().manual_seed(s)
    spec_a, spec_c, la, lc = _pair(MAIN_GROUPS, g, cuda)
    x = (2.0 * torch.randn((s, spec_a.obs_dim), generator=g)).to(cuda)
    loss, rows = _chip_smoke().loss_inputs(spec_a, spec_c, la, lc, x, g)
    args = (spec_a, spec_c, loss, la, lc, *rows)
    n = fe.pair_forward_loss.launches
    out9 = fe.pair_forward_loss(*args)
    out10 = fe.pair_forward_loss_agrad(*args)
    torch.cuda.synchronize()
    assert fe.pair_forward_loss.launches == n + 1
    rows_tol, stats_tol = fe.loss_row_tols(s)
    ref = fe.reference_pair_fwd_loss(*args)
    exact = in_f64(fe.reference_pair_fwd_loss, *args)
    for got, want, ex in zip(out9[:3], ref[:3], exact[:3]):
        _close(got, want, rows_tol, ex)
    for col in range(out9[3].shape[1]):
        _close(out9[3][:, col], ref[3][:, col], stats_tol, exact[3][:, col])
    _forward_bits(args, out9, out10)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4097])
def test_generic_tp_kernels_match_plain_version(cuda, n):
    """The TP forward and backward at F 91, T 40, O 120 (the generic
    instance: 6 input k-tiles, 2 head passes, stage B's dwfc past one
    128-column product), at the warp tile's edges; repeat launches agree."""
    f, t, o = WIDE_TP
    g = torch.Generator().manual_seed(n)
    spec = tl.TPLSTMSpec(input_dim=f, hidden=64, t_steps=t, out_dim=o)
    lt = _leaves(spec.leaf_shapes(), g, cuda)
    xt = torch.randn((n, t, f), generator=g).to(cuda)
    dy = torch.randn((n, o), generator=g).to(cuda)
    y = tl.tp_forward(spec, lt, xt)
    _close(y, tl.reference_forward(spec, lt, xt), tl.KERNEL_TOL,
           in_f64(tl.reference_forward, spec, lt, xt))
    grads = tl.tp_backward(spec, lt, xt, dy)
    again = tl.tp_backward(spec, lt, xt, dy)
    torch.cuda.synchronize()
    _bwd_close(grads, tl.reference_backward(spec, lt, xt, dy), tl.BWD_KERNEL_TOL,
               in_f64(tl.reference_backward, spec, lt, xt, dy))
    assert all(torch.equal(u, v) for u, v in zip(grads, again))
    assert torch.equal(y, tl.tp_forward(spec, lt, xt))


@pytest.mark.gpu
@pytest.mark.parametrize("f,o", [(150, 15), (16, 200), (200, 136), (400, 15), (16, 1000)])
def test_tp_kernels_past_one_weight_product(cuda, f, o):
    """Inputs and outputs past stage B's 128 columns (dwi and dwfc split into
    column blocks); at 400 inputs (both kernels) and 1,000 outputs (the
    backward) wi and wfc do not fit a block's shared memory and the generic
    instance reads them from device memory."""
    g = torch.Generator().manual_seed(f + o)
    spec = tl.TPLSTMSpec(input_dim=f, hidden=64, t_steps=6, out_dim=o)
    lt = _leaves(spec.leaf_shapes(), g, cuda)
    xt = torch.randn((33, 6, f), generator=g).to(cuda)
    dy = torch.randn((33, o), generator=g).to(cuda)
    _close(tl.tp_forward(spec, lt, xt), tl.reference_forward(spec, lt, xt), tl.KERNEL_TOL,
           in_f64(tl.reference_forward, spec, lt, xt))
    _bwd_close(tl.tp_backward(spec, lt, xt, dy), tl.reference_backward(spec, lt, xt, dy),
               tl.BWD_KERNEL_TOL, in_f64(tl.reference_backward, spec, lt, xt, dy))
