"""The CUDA kernel wrappers' contract, checked without a GPU, and the kernels
against their plain versions where there is one.

On CPU tensors a wrapper runs its plain version and counts no launch; on a
tensor of any other device it launches its kernel or raises, never falling
back.  The kernel tests (marker `gpu`) skip without a CUDA card; run them on
one with `python -m pytest tests/test_torch_kernels.py -m gpu --noconftest`
(this file needs no JAX, the suite's conftest does).  Kernel and
plain version round the same operands to bf16 and sum in f32 in another
order, so a few values near a bf16 rounding boundary round one ulp apart:
each module's `KERNEL_TOL` bounds the largest error at 5e-3 of the output
scale and the mean error at 1e-4 of the mean magnitude
(mupe_tpu_torch/ops/tolerance.py).  The plain version in f32 throughout,
the stand-in for a kernel that misses a rounding point, must fail it.  The
FPS kernel sums the same f32 values in the same order as its plain version:
its indices must be equal.
"""
import ast
import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest
import torch

import mupe_tpu_torch
from mupe_tpu_torch.ops import build
from mupe_tpu_torch.ops import fps
from mupe_tpu_torch.ops import fused_encoder as fe
from mupe_tpu_torch.ops import tp_lstm as tl
from mupe_tpu_torch.ops.tolerance import KernelTol, in_f64

torch.set_num_threads(1)
GROUPS = ((1, 35), (3, 5), (2, 3))
PKG = Path(mupe_tpu_torch.__file__).resolve().parent


def _leaves(shapes, gen, device="cpu"):
    return [
        (torch.randn(s, generator=gen) / math.sqrt(s[0]) if len(s) == 2
         else 0.1 * torch.randn(s, generator=gen)).to(device)
        for s in shapes
    ]


def _encoder_case(s, device="cpu"):
    g = torch.Generator().manual_seed(s)
    spec_a = fe.EncoderSpec(groups=GROUPS, head_dim=4)
    spec_c = fe.EncoderSpec(groups=GROUPS, head_dim=1)
    la = _leaves(fe.leaf_shapes(spec_a), g, device)
    lc = _leaves(fe.leaf_shapes(spec_c), g, device)
    x = (2.0 * torch.randn((s, spec_a.obs_dim), generator=g)).to(device)
    return spec_a, spec_c, la, lc, x


def _tp_case(n, device="cpu"):
    g = torch.Generator().manual_seed(n)
    spec = tl.TPLSTMSpec(input_dim=16, hidden=64, t_steps=10, out_dim=15)
    return spec, _leaves(spec.leaf_shapes(), g, device), torch.randn((n, 10, 16), generator=g).to(device)


def _fps_case(n, device="cpu", d=27, keep_last=None):
    """An AEG-like pool: uniform points (normalised tasks); with `keep_last`,
    the last rows kept at random as `update_history`'s kept eval tasks."""
    g = torch.Generator().manual_seed(n)
    pts = torch.rand((n, d), generator=g)
    valid = torch.ones(n, dtype=torch.bool)
    if keep_last:
        valid[-keep_last:] = torch.rand(keep_last, generator=g) < 0.6
    return pts.to(device), valid.to(device)


def _loss_case(s, device="cpu", saturate=False):
    """An encoder pair over s rows with the in-kernel loss's inputs from
    chip_smoke.py's `loss_inputs` (ratios and value offsets kept off the clip
    rails): (spec_a, spec_c, la, lc, x, the loss wrappers' arguments)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", PKG.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    spec_a, spec_c, la, lc, x = _encoder_case(s, device)
    loss, rows = cs.loss_inputs(spec_a, spec_c, la, lc, x, torch.Generator().manual_seed(s),
                                saturate)
    return spec_a, spec_c, la, lc, x, (spec_a, spec_c, loss, la, lc, *rows)


def _launch_counts():
    return (fe.encoder_forward.launches, fe.encoder_pair_forward.launches,
            tl.tp_forward.launches, fe.encoder_backward.launches, tl.tp_backward.launches,
            fps.farthest_point_sampling.launches, fe.pair_forward_loss.launches,
            fe.pair_forward_loss_agrad.launches, fe.weight_grads.launches)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    spec_a, spec_c, la, lc, x = _encoder_case(17)
    before = _launch_counts()
    a, c = fe.encoder_pair_forward(spec_a, spec_c, la, lc, x)
    assert torch.equal(a, fe.reference_apply(spec_a, la, x))
    assert torch.equal(c, fe.reference_apply(spec_c, lc, x))
    assert torch.equal(fe.encoder_forward(spec_c, lc, x), c)
    spec, lt, xt = _tp_case(9)
    assert torch.equal(tl.tp_forward(spec, lt, xt), tl.reference_forward(spec, lt, xt))
    pts, valid = _fps_case(40)
    assert torch.equal(fps.farthest_point_sampling(pts, 9, valid, 3),
                       fps.reference_fps(pts, 9, valid, 3))
    assert _launch_counts() == before


def test_cpu_tensors_take_the_plain_backward_and_count_no_launch():
    """The backward wrappers and the autograd Functions under the forward
    wrappers run `reference_backward` for CPU tensors."""
    spec_a, spec_c, la, lc, x = _encoder_case(19)
    before = _launch_counts()
    g = torch.Generator().manual_seed(3)
    da, dc = torch.randn((19, 4), generator=g), torch.randn((19, 1), generator=g)
    la = [l.requires_grad_() for l in la]
    lc = [l.requires_grad_() for l in lc]
    a, c = fe.encoder_pair_forward(spec_a, spec_c, la, lc, x)
    grads = torch.autograd.grad((a * da).sum() + (c * dc).sum(), la + lc)
    want = (fe.reference_backward(spec_a, [l.detach() for l in la], x, da)
            + fe.reference_backward(spec_c, [l.detach() for l in lc], x, dc))
    assert all(torch.equal(u, v) for u, v in zip(grads, want))
    (ga,) = fe.encoder_backward([(spec_c, [l.detach() for l in lc])], x, [dc])
    assert all(torch.equal(u, v) for u, v in zip(ga, want[len(la):]))
    # the weight-gradient stage alone, on the plain first stage's staging
    staged, sums = fe.reference_backward_operands(spec_c, [l.detach() for l in lc], x, dc)
    flat = torch.zeros(fe.n_params(spec_c))
    fe.weight_grads([(spec_c, staged, flat)])
    got = fe.split_flat(spec_c, flat)
    assert all(torch.equal(got[i], want[len(la) + i]) for i in fe.weight_leaves(spec_c))
    spec, lt, xt = _tp_case(11)
    lt = [l.requires_grad_() for l in lt]
    dy = torch.randn((11, 15), generator=g)
    grads = torch.autograd.grad((tl.tp_forward(spec, lt, xt) * dy).sum(), lt)
    want = tl.reference_backward(spec, [l.detach() for l in lt], xt, dy)
    assert all(torch.equal(u, v) for u, v in zip(grads, want))
    assert _launch_counts() == before


def test_cpu_tensors_take_the_plain_loss_versions_and_count_no_launch():
    *_, args = _loss_case(23)
    before = _launch_counts()
    got = fe.pair_forward_loss(*args)
    assert all(torch.equal(u, v) for u, v in zip(got, fe.reference_pair_fwd_loss(*args)))
    dv1, dv2, stats, grads = fe.pair_forward_loss_agrad(*args)
    want = fe.reference_pair_fwd_loss_agrad(*args)
    assert all(torch.equal(u, v) for u, v in zip((dv1, dv2, stats, *grads),
                                                 (*want[:3], *want[3])))
    assert _launch_counts() == before


def test_non_cpu_tensors_never_fall_back_to_the_plain_version():
    """A tensor on another device goes to the kernel path, whose checks
    raise for anything but a contiguous float32 CUDA tensor."""
    spec_a, spec_c, la, lc, x = _encoder_case(5)
    with pytest.raises(ValueError, match="CUDA"):
        fe.encoder_forward(spec_c, lc, x.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        fe.encoder_pair_forward(spec_a, spec_c, la, lc, x.to("meta"))
    spec, lt, xt = _tp_case(3)
    with pytest.raises(ValueError, match="CUDA"):
        tl.tp_forward(spec, lt, xt.to("meta"))
    dout = torch.zeros((5, 1), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fe.encoder_backward([(spec_c, lc)], x.to("meta"), [dout])
    with pytest.raises(ValueError, match="CUDA"):
        tl.tp_backward(spec, lt, xt.to("meta"), torch.zeros((3, 15), device="meta"))
    pts, valid = _fps_case(10)
    with pytest.raises(ValueError, match="CUDA"):
        fps.farthest_point_sampling(pts.to("meta"), 4, valid.to("meta"))
    *_, args = _loss_case(6)
    meta_args = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    for fn in (fe.pair_forward_loss, fe.pair_forward_loss_agrad):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*meta_args)


@pytest.mark.parametrize("shape", [(10, 4, 16), (4, 16), (4, 10, 15), (4, 17, 16), (16,)],
                         ids=["transposed", "no_window", "narrow", "longer", "flat"])
def test_tp_forward_rejects_windows_of_another_shape_on_the_cpu(shape):
    """The CPU path holds the windows to the spec as the kernel path does: a
    window of another length is an error, not a shorter or longer LSTM."""
    spec, lt, _ = _tp_case(4)
    with pytest.raises(ValueError, match=r"windows must be \[\.\.\., 10, 16\]"):
        tl.tp_forward(spec, lt, torch.zeros(shape))


def test_c_sources_and_build_helper_exist():
    for name in build.SOURCES:
        src = (build.CSRC / name).read_text()
        assert "Replaces the TPU kernel" in src and "mupe_tpu/ops/" in src
        assert "What bounds it on an H100" in src
        assert "cudaGetLastError()" in src
    exported = "".join((build.CSRC / n).read_text() for n in build.SOURCES)
    for fn in build.C_FUNCTIONS:
        assert f'extern "C" int {fn}(' in exported
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    path = build.library_path()
    assert path.parent == PKG / "_build" and build.source_hash() in path.name
    assert "mupe_tpu_torch/_build/" in (PKG.parent / ".gitignore").read_text()


def test_mupe_tpu_torch_imports_no_jax_or_flax():
    """The package and chip_smoke.py (which runs where JAX is not
    installed) import nothing of JAX, flax, optax or the JAX package."""
    banned = {"jax", "flax", "optax", "mupe_tpu"}
    for path in [*PKG.rglob("*.py"), PKG.parent / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"


@pytest.mark.parametrize("net", ["actor", "critic", "tp", "loss"])
def test_kernel_tolerance_rejects_the_plain_version_without_bf16_rounding(net):
    spec_a, spec_c, la, lc, x = _encoder_case(300)
    spec, lt, xt = _tp_case(300)
    *_, args = _loss_case(300)
    """Held to the limits the card applies: with the plain version in f64
    given, each limit is at least `floor_mult` times the f32 plain version's
    error against it."""
    plain, inputs, tol = {
        "actor": (fe.reference_apply, (spec_a, la, x), fe.KERNEL_TOL),
        "critic": (fe.reference_apply, (spec_c, lc, x), fe.KERNEL_TOL),
        "tp": (tl.reference_forward, (spec, lt, xt), tl.KERNEL_TOL),
        "loss": (lambda *a, **k: fe.reference_pair_fwd_loss(*a, **k)[0], args, fe.KERNEL_TOL),
    }[net]
    ref = plain(*inputs)
    exact = in_f64(plain, *inputs)
    errs = tol.errors(plain(*inputs, bf16=False), ref, exact)
    assert errs["mean_rel"] > 10 * errs["mean_limit"], errs
    assert not tol.holds(errs)
    assert tol.holds(tol.errors(ref.clone(), ref, exact))


def test_kernel_tolerance_catches_a_dropped_row_and_nan():
    tol = KernelTol(max_rel=5e-3, mean_rel=1e-4)
    ref = torch.randn((12289, 4), generator=torch.Generator().manual_seed(0))
    dropped = ref.clone()
    dropped[-1] = 0.0
    errs = tol.errors(dropped, ref)
    assert errs["max_rel"] > tol.max_rel and not tol.holds(errs)
    nan = ref.clone()
    nan[3, 1] = float("nan")
    assert not tol.holds(tol.errors(nan, ref))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only on the GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close_scaled(out, ref, tol, exact=None):
    errs = tol.errors(out, ref, exact)
    assert tol.holds(errs), errs


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 7, 8, 12288, 12289, 49152])
def test_encoder_kernel_matches_plain_version(cuda, s):
    spec_a, spec_c, la, lc, x = _encoder_case(s, cuda)
    n = fe.encoder_pair_forward.launches
    a, c = fe.encoder_pair_forward(spec_a, spec_c, la, lc, x)
    torch.cuda.synchronize()
    assert fe.encoder_pair_forward.launches == n + 1
    exact_c = in_f64(fe.reference_apply, spec_c, lc, x)
    _close_scaled(a, fe.reference_apply(spec_a, la, x), fe.KERNEL_TOL,
                  in_f64(fe.reference_apply, spec_a, la, x))
    _close_scaled(c, fe.reference_apply(spec_c, lc, x), fe.KERNEL_TOL, exact_c)
    _close_scaled(fe.encoder_forward(spec_c, lc, x), fe.reference_apply(spec_c, lc, x),
                  fe.KERNEL_TOL, exact_c)


# Specs past the main path's: 7 tokens (num_agents=4), 8 tokens with
# state_self 50 wide (num_agents=4, obs_max_cylinder=4,
# future_prediction_step=10), 12 tokens (num_agents=4, obs_max_cylinder=8)
# and 16 tokens over 148 columns (num_agents=6, obs_max_cylinder=10,
# future_prediction_step=21); their stage-A tile is 8 rows, past 8 tokens
# the kernels' 16-token instance.
WIDE_GROUPS = {"7 tokens": ((1, 35), (3, 5), (3, 3)), "8 tokens, wide": ((1, 50), (4, 5), (3, 3)),
               "12 tokens": ((1, 50), (8, 5), (3, 3)),
               "16 tokens, wide": ((1, 83), (10, 5), (5, 3))}


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 7, 8, 9, 17, 4099])
@pytest.mark.parametrize("groups", list(WIDE_GROUPS), ids=list(WIDE_GROUPS))
def test_wide_spec_kernels_match_plain_version(cuda, groups, s):
    """The forward, the pair backward and the two loss kernels at 7, 8 (a
    50-wide group), 12 and 16 tokens (148 columns), at the 8-row tile's
    edges: within their limits of the plain versions, every row counted
    (dbh == S)."""
    g = torch.Generator().manual_seed(s)
    spec_a = fe.EncoderSpec(groups=WIDE_GROUPS[groups], head_dim=4)
    spec_c = fe.EncoderSpec(groups=WIDE_GROUPS[groups], head_dim=1)
    la = _leaves(fe.leaf_shapes(spec_a), g, cuda)
    lc = _leaves(fe.leaf_shapes(spec_c), g, cuda)
    x = (2.0 * torch.randn((s, spec_a.obs_dim), generator=g)).to(cuda)
    a, c = fe.encoder_pair_forward(spec_a, spec_c, la, lc, x)
    _close_scaled(a, fe.reference_apply(spec_a, la, x), fe.KERNEL_TOL,
                  in_f64(fe.reference_apply, spec_a, la, x))
    _close_scaled(c, fe.reference_apply(spec_c, lc, x), fe.KERNEL_TOL,
                  in_f64(fe.reference_apply, spec_c, lc, x))
    da = torch.randn((s, 4), generator=g).to(cuda)
    ones = torch.ones((s, 1), device=cuda)
    tol = fe.BWD_KERNEL_TOL if s >= 300 else dataclasses.replace(fe.BWD_KERNEL_TOL, mean_rel=5e-3)
    ga, gc = fe.encoder_backward([(spec_a, la), (spec_c, lc)], x, [da, ones])
    _bwd_close(ga, fe.reference_backward(spec_a, la, x, da), tol,
               in_f64(fe.reference_backward, spec_a, la, x, da))
    _bwd_close(gc, fe.reference_backward(spec_c, lc, x, ones), tol,
               in_f64(fe.reference_backward, spec_c, lc, x, ones))
    assert gc[-1].item() == float(s)
    spec = importlib.util.spec_from_file_location("chip_smoke", PKG.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    loss, rows = cs.loss_inputs(spec_a, spec_c, la, lc, x, g)
    args = (spec_a, spec_c, loss, la, lc, *rows)
    rows_tol, stats_tol = fe.loss_row_tols(s)
    ref = fe.reference_pair_fwd_loss(*args)
    exact = in_f64(fe.reference_pair_fwd_loss, *args)
    out9 = fe.pair_forward_loss(*args)
    out10 = fe.pair_forward_loss_agrad(*args)
    for got, want, ex in zip((*out9[:3], *out10[:2]), (*ref[:3], *ref[1:3]),
                             (*exact[:3], *exact[1:3])):
        _close_scaled(got, want, rows_tol, ex)
    for st in (out9[3], out10[2]):
        for col in range(st.shape[1]):
            _close_scaled(st[:, col], ref[3][:, col], stats_tol, exact[3][:, col])
    _bwd_close(out10[3], fe.reference_backward(spec_a, la, x, ref[0]), tol,
               in_f64(fe.reference_pair_fwd_loss_agrad, *args)[3])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4096, 4097, 241664])
def test_tp_kernel_matches_plain_version(cuda, n):
    """At the warp tile's edges (16 windows), the rollout's and the update's
    sizes; with the floor-relative limits; a second launch gives the same
    bits."""
    spec, lt, xt = _tp_case(n, cuda)
    y = tl.tp_forward(spec, lt, xt)
    again = tl.tp_forward(spec, lt, xt)
    torch.cuda.synchronize()
    _close_scaled(y, tl.reference_forward(spec, lt, xt), tl.KERNEL_TOL,
                  in_f64(tl.reference_forward, spec, lt, xt))
    assert torch.equal(y, again)


def _bwd_close(outs, refs, tol, exact=None):
    errs = tol.errors(outs, refs, exact)
    assert tol.holds(errs), [(i, errs[i]) for i in tol.failing(errs)]


@pytest.mark.gpu
@pytest.mark.parametrize("nets", [1, 2])
@pytest.mark.parametrize("s", [1, 7, 8, 15, 16, 17, 49152, 49153])
def test_encoder_backward_kernel_matches_plain_version(cuda, s, nets):
    """Gradients within `BWD_KERNEL_TOL` of `reference_backward`, one or two
    networks a launch; a second launch gives the same bits; with dout = 1
    the critic's head-bias gradient is exactly S (every row counted).
    Below 300 rows the mean limit is 5e-3: a sum over a handful of rows
    averages no rounding flip away (one flip moved a leaf's mean error to
    1.2e-3 at S = 8 on an H100)."""
    spec_a, spec_c, la, lc, x = _encoder_case(s, cuda)
    g = torch.Generator().manual_seed(s + 1)
    da = torch.randn((s, 4), generator=g).to(cuda)
    ones = torch.ones((s, 1), device=cuda)
    case = [(spec_a, la), (spec_c, lc)][2 - nets:]
    douts = [da, ones][2 - nets:]
    n = (fe.encoder_backward.launches, fe.weight_grads.launches)
    grads = fe.encoder_backward(case, x, douts)
    again = fe.encoder_backward(case, x, douts)
    torch.cuda.synchronize()
    assert (fe.encoder_backward.launches, fe.weight_grads.launches) == (n[0] + 2, n[1] + 2)
    tol = fe.BWD_KERNEL_TOL if s >= 300 else dataclasses.replace(fe.BWD_KERNEL_TOL, mean_rel=5e-3)
    for (spec, leaves), d, gk, g2 in zip(case, douts, grads, again):
        _bwd_close(gk, fe.reference_backward(spec, leaves, x, d), tol,
                   in_f64(fe.reference_backward, spec, leaves, x, d))
        assert all(torch.equal(u, v) for u, v in zip(gk, g2))
    assert grads[-1][-1].item() == float(s)


@pytest.mark.gpu
@pytest.mark.parametrize("s,saturate", [(1, False), (7, False), (8, False), (49152, False),
                                        (49153, False), (49152, True)])
def test_loss_kernels_match_plain_version(cuda, s, saturate):
    """The fwdloss kernel's dmu, dv1, dv2 and stats (column by column) and the
    agrad kernel's dv1, dv2, stats and actor gradients within the limits of
    the forward and backward kernels; a repeat launch gives the same bits,
    and the actor's head-bias gradient is the column sum of dmu (every row
    counted; against the plain dmu, DMU_SUM_TOL: the agrad kernel's forward
    runs on the tensor cores, the fwdloss kernel's on the CUDA cores, so
    their dmu are not the same bits).  Saturated rows (log-ratio past +-20)
    get dmu = 0."""
    spec_a, spec_c, la, lc, x, args = _loss_case(s, cuda, saturate)
    n = (fe.pair_forward_loss.launches, fe.pair_forward_loss_agrad.launches)
    dmu, dv1, dv2, stats = fe.pair_forward_loss(*args)
    out = fe.pair_forward_loss_agrad(*args)
    again = fe.pair_forward_loss_agrad(*args)
    torch.cuda.synchronize()
    assert (fe.pair_forward_loss.launches, fe.pair_forward_loss_agrad.launches) == (n[0] + 1,
                                                                                    n[1] + 2)
    ref = fe.reference_pair_fwd_loss(*args)
    exact = in_f64(fe.reference_pair_fwd_loss, *args)
    rows_tol, stats_tol = fe.loss_row_tols(s)
    for got, want, ex in zip((dmu, dv1, dv2, out[0], out[1]), (*ref[:3], *ref[1:3]),
                             (*exact[:3], *exact[1:3])):
        _close_scaled(got, want, rows_tol, ex)
    for st in (stats, out[2]):
        for c in range(st.shape[1]):
            _close_scaled(st[:, c], ref[3][:, c], stats_tol, exact[3][:, c])
    tol = fe.BWD_KERNEL_TOL if s >= 300 else dataclasses.replace(fe.BWD_KERNEL_TOL, mean_rel=5e-3)
    _bwd_close(out[3], fe.reference_backward(spec_a, la, x, ref[0]), tol,
               in_f64(fe.reference_pair_fwd_loss_agrad, *args)[3])
    assert all(torch.equal(u, v) for u, v in zip((*out[:3], *out[3]), (*again[:3], *again[3])))
    _close_scaled(out[3][-1], ref[0].sum(0), fe.DMU_SUM_TOL)
    if saturate:
        k = s // 6
        assert float(torch.cat([dmu[:k], dmu[s - k:]]).abs().max()) == 0.0


@pytest.mark.gpu
def test_loss_wrappers_reject_bad_inputs(cuda):
    spec_a, spec_c, la, lc, x, args = _loss_case(8, cuda)
    loss, log_std, _, act, logp_old, adv, v_old, ret = args[2], *args[5:]
    for fn in (fe.pair_forward_loss, fe.pair_forward_loss_agrad):
        with pytest.raises(ValueError):  # a row input of the wrong shape
            fn(spec_a, spec_c, loss, la, lc, log_std, x, act, logp_old[:4], adv, v_old, ret)
        with pytest.raises(ValueError):  # a row input on the CPU
            fn(spec_a, spec_c, loss, la, lc, log_std, x, act.cpu(), logp_old, adv, v_old, ret)
        with pytest.raises(ValueError):  # n_rows is not S
            fn(spec_a, spec_c, dataclasses.replace(loss, n_rows=9), la, lc, log_std, x, act,
               logp_old, adv, v_old, ret)
        with pytest.raises(ValueError):  # the networks swapped
            fn(spec_c, spec_a, loss, lc, la, log_std, x, act, logp_old, adv, v_old, ret)


def _staged_on(spec, staged, s, device):
    """The plain first stage's staging in the kernel's form: bf16, S padded
    to staged_rows(S) with zero rows, the x slices' columns to 16."""
    st, _ = fe._alloc_staging(spec, s, device)
    for k in fe._STAGED:
        st[k].zero_()
        st[k][..., :s, :] = staged[k].to(torch.bfloat16)
    for g, (_, d) in enumerate(spec.groups):
        st["xs"][g].zero_()
        st["xs"][g][:, :s, :d] = staged["xs"][g].to(torch.bfloat16)
    return st


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 17, 49152, 49153])
def test_weight_grads_kernel_matches_plain_version(cuda, s):
    """Stage B alone: the split-K kernel against `reference_weight_grads` on
    the same staged operands, to WEIGHT_GRAD_TOL (sum order only); the other
    leaves of the flat vector are left alone; a repeat gives the same bits."""
    spec_a, _, la, _, x = _encoder_case(s, cuda)
    d = torch.randn((s, 4), generator=torch.Generator().manual_seed(s)).to(cuda)
    st = _staged_on(spec_a, fe.reference_backward_operands(spec_a, la, x, d)[0], s, cuda)
    flat = torch.full((fe.n_params(spec_a),), 7.0, device=cuda)
    n = fe.weight_grads.launches
    fe.weight_grads([(spec_a, st, flat)])
    again = flat.clone()
    fe.weight_grads([(spec_a, st, again)])
    torch.cuda.synchronize()
    assert fe.weight_grads.launches == n + 2 and torch.equal(flat, again)
    views, ref = fe.split_flat(spec_a, flat), fe.reference_weight_grads(spec_a, st)
    wl = fe.weight_leaves(spec_a)
    _bwd_close([views[i] for i in wl], [ref[i] for i in wl], fe.WEIGHT_GRAD_TOL)
    assert all(bool((views[i] == 7.0).all()) for i in range(spec_a.n_leaves) if i not in wl)


@pytest.mark.gpu
def test_weight_grads_rejects_bad_staging(cuda):
    """The stage-B wrapper raises on a staged operand that is not contiguous
    bf16 on the gradient's device, or does not match its product."""
    spec_a, _, la, _, x = _encoder_case(40, cuda)
    d = torch.randn((40, 4), device=cuda)
    st = _staged_on(spec_a, fe.reference_backward_operands(spec_a, la, x, d)[0], 40, cuda)
    flat = torch.zeros(fe.n_params(spec_a), device=cuda)
    for key, bad in (("dq", st["dq"].float()), ("dq", st["dq"].t()),
                     ("dr2", st["dr2"].cpu()), ("y1", st["y1"][:32])):
        with pytest.raises(ValueError):
            fe.weight_grads([(spec_a, dict(st, **{key: bad}), flat)])
    with pytest.raises(ValueError):
        fe.weight_grads([(spec_a, dict(st, xs=(st["xs"][0].float(), *st["xs"][1:])), flat)])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4096, 241664, 241665])
def test_tp_backward_kernel_matches_plain_version(cuda, n):
    spec, lt, xt = _tp_case(n, cuda)
    dy = torch.randn((n, 15), generator=torch.Generator().manual_seed(n + 1)).to(cuda)
    grads = tl.tp_backward(spec, lt, xt, dy)
    again = tl.tp_backward(spec, lt, xt, dy)
    torch.cuda.synchronize()
    _bwd_close(grads, tl.reference_backward(spec, lt, xt, dy), tl.BWD_KERNEL_TOL,
               in_f64(tl.reference_backward, spec, lt, xt, dy))
    assert all(torch.equal(u, v) for u, v in zip(grads, again))


@pytest.mark.gpu
@pytest.mark.parametrize("f,t,o", [(16, 10, 15), (34, 20, 30)])
def test_tp_windows_past_n_add_exact_zeros(cuda, f, t, o):
    """17 windows against 32 whose last 15 have a zero cotangent: the same
    forward rows and the same gradient bits (the warp tile's padding windows
    run on zeros and add nothing)."""
    g = torch.Generator().manual_seed(f)
    spec = tl.TPLSTMSpec(input_dim=f, hidden=64, t_steps=t, out_dim=o)
    lt = _leaves(spec.leaf_shapes(), g, cuda)
    x = torch.randn((32, t, f), generator=g).to(cuda)
    dy = torch.randn((32, o), generator=g).to(cuda)
    dy[17:] = 0.0
    x17, dy17 = x[:17].contiguous(), dy[:17].contiguous()
    assert torch.equal(tl.tp_forward(spec, lt, x)[:17], tl.tp_forward(spec, lt, x17))
    assert all(torch.equal(u, v) for u, v in zip(tl.tp_backward(spec, lt, x, dy),
                                                 tl.tp_backward(spec, lt, x17, dy17)))


@pytest.mark.gpu
def test_forward_takes_specs_in_any_order(cuda):
    """A larger spec after a smaller one: the forward's shared-memory
    attribute, set once a device, never drops below a spec's carve."""
    order = [WIDE_GROUPS["8 tokens, wide"], WIDE_GROUPS["7 tokens"], GROUPS,
             WIDE_GROUPS["8 tokens, wide"], GROUPS, WIDE_GROUPS["7 tokens"],
             WIDE_GROUPS["16 tokens, wide"], GROUPS, WIDE_GROUPS["16 tokens, wide"]]
    for i, groups in enumerate(order):
        g = torch.Generator().manual_seed(i)
        spec_a = fe.EncoderSpec(groups=groups, head_dim=4)
        spec_c = fe.EncoderSpec(groups=groups, head_dim=1)
        la = _leaves(fe.leaf_shapes(spec_a), g, cuda)
        lc = _leaves(fe.leaf_shapes(spec_c), g, cuda)
        x = (2.0 * torch.randn((4099, spec_a.obs_dim), generator=g)).to(cuda)
        a, c = fe.encoder_pair_forward(spec_a, spec_c, la, lc, x)
        _close_scaled(a, fe.reference_apply(spec_a, la, x), fe.KERNEL_TOL,
                      in_f64(fe.reference_apply, spec_a, la, x))
        _close_scaled(c, fe.reference_apply(spec_c, lc, x), fe.KERNEL_TOL,
                      in_f64(fe.reference_apply, spec_c, lc, x))


@pytest.mark.gpu
@pytest.mark.parametrize("f,t,o", [(19, 20, 18), (34, 20, 30), (64, 32, 64)])
@pytest.mark.parametrize("n", [1, 15, 4097])
def test_wide_tp_backward_kernel_matches_plain_version(cuda, n, f, t, o):
    """The TP kernels past the main path's inputs (F 16): the warp tile's
    instances of 2, 3 and 4 input k-tiles, up to the kernels' limits."""
    g = torch.Generator().manual_seed(n + f)
    spec = tl.TPLSTMSpec(input_dim=f, hidden=64, t_steps=t, out_dim=o)
    lt = _leaves(spec.leaf_shapes(), g, cuda)
    xt = torch.randn((n, t, f), generator=g).to(cuda)
    dy = torch.randn((n, o), generator=g).to(cuda)
    _close_scaled(tl.tp_forward(spec, lt, xt), tl.reference_forward(spec, lt, xt), tl.KERNEL_TOL,
                  in_f64(tl.reference_forward, spec, lt, xt))
    grads = tl.tp_backward(spec, lt, xt, dy)
    again = tl.tp_backward(spec, lt, xt, dy)
    torch.cuda.synchronize()
    _bwd_close(grads, tl.reference_backward(spec, lt, xt, dy), tl.BWD_KERNEL_TOL,
               in_f64(tl.reference_backward, spec, lt, xt, dy))
    assert all(torch.equal(u, v) for u, v in zip(grads, again))


@pytest.mark.gpu
def test_backward_wrappers_reject_bad_inputs(cuda):
    spec_a, spec_c, la, lc, x = _encoder_case(8, cuda)
    d = torch.ones((8, 1), device=cuda)
    with pytest.raises(ValueError):
        fe.encoder_backward([(spec_c, lc)], x, [d.double()])
    with pytest.raises(ValueError):
        fe.encoder_backward([(spec_c, lc)], x, [torch.ones((8, 2), device=cuda)])
    with pytest.raises(ValueError):
        fe.encoder_backward([(spec_c, lc)], x.double(), [d])
    with pytest.raises(ValueError):
        fe.encoder_backward([(spec_c, [l.cpu() for l in lc])], x, [d])
    spec, lt, xt = _tp_case(4, cuda)
    with pytest.raises(ValueError):
        tl.tp_backward(spec, lt, xt, torch.ones((4, 14), device=cuda))
    with pytest.raises(ValueError):
        tl.tp_backward(spec, lt, xt.transpose(0, 1).contiguous(), torch.ones((4, 15), device=cuda))
    with pytest.raises(ValueError):
        tl.tp_backward(spec, lt, xt, torch.ones((4, 15), device=cuda).cpu())


@pytest.mark.gpu
def test_kernel_wrappers_reject_bad_inputs(cuda):
    spec_a, spec_c, la, lc, x = _encoder_case(8, cuda)
    with pytest.raises(ValueError):
        fe.encoder_forward(spec_c, lc, x.double())
    with pytest.raises(ValueError):
        fe.encoder_forward(spec_c, lc, x[:, :50])
    with pytest.raises(ValueError):
        fe.encoder_forward(spec_c, [l.cpu() for l in lc], x)
    spec, lt, xt = _tp_case(4, cuda)
    with pytest.raises(ValueError):
        tl.tp_forward(spec, lt, xt.transpose(0, 1))
    with pytest.raises(ValueError):  # 15 input features for a 16-wide wi
        tl.tp_forward(spec, lt, xt[..., :15])
    with pytest.raises(ValueError):  # 33 steps for a spec of 10
        tl.tp_forward(spec, lt, torch.zeros((4, 33, 16), device=cuda))


def _fps_named_case(name, device):
    """chip_smoke's FPS cases past the AEG pool: the block-split edges of the
    cluster at N = 9,096 ("edge-1", "edge", "edge+1": N = C r - 1, C r, C r
    + 1 for its r rows a block), duplicate far rows in different blocks'
    ranges ("tie" resident, "tie_streamed" at N = 49,153), 50 rows repeated
    over the pool ("repeat"), 300 valid points spread over it ("sparse").
    Returns (points, valid, k)."""
    if name.startswith("edge"):
        c, _ = fps.plan(9096, 27, device)
        rows = -(-9096 // c)
        n = c * rows + {"edge-1": -1, "edge": 0, "edge+1": 1}[name]
        pts, valid = _fps_case(n, device, 27, 4096)
        return pts, valid, 5000
    n = 49153 if name == "tie_streamed" else 9096
    g = torch.Generator().manual_seed(n + len(name))
    pts = torch.rand((n, 27), generator=g)
    valid = torch.ones(n, dtype=torch.bool)
    if name.startswith("tie"):
        pts[[n // 7, 3 * n // 7, 6 * n // 7]] = 2.0
        pts[[n // 5, 4 * n // 5]] = -1.5
    elif name == "repeat":
        pts = torch.rand((50, 27), generator=g)[torch.arange(n) % 50]
    elif name == "sparse":
        valid = torch.zeros(n, dtype=torch.bool)
        valid[torch.randperm(n, generator=g)[:300]] = True
    return pts.to(device), valid.to(device), 500


def _fps_holds(pts, valid, k):
    """Index for index equal to `reference_fps` (the same f32 sums in the same
    order), bit-identical on a repeat, no invalid point chosen."""
    start = torch.argmax(valid.to(torch.uint8))
    launches = fps.farthest_point_sampling.launches
    idx = fps.farthest_point_sampling(pts, k, valid, start)
    again = fps.farthest_point_sampling(pts, k, valid, start)
    torch.cuda.synchronize()
    assert fps.farthest_point_sampling.launches == launches + 2
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (k,)
    assert torch.equal(idx, fps.reference_fps(pts, k, valid, start))
    assert torch.equal(idx, again)
    assert bool(valid[idx.long()].all())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["edge-1", "edge", "edge+1", "tie", "tie_streamed", "repeat",
                                  "sparse"])
def test_fps_kernel_at_the_edges_and_ties(cuda, name):
    _fps_holds(*_fps_named_case(name, cuda))


@pytest.mark.gpu
def test_fps_kernel_switches_instances(cuda):
    """A streamed pool (N = 49,153), then a pool in registers (the AEG's),
    then the streamed one again: each instance sets its own attributes."""
    for n in (49153, 9096, 49153):
        pts, valid = _fps_case(n, cuda, 27, 4096)
        _fps_holds(pts, valid, 500)
    assert fps.plan(49153, 27, cuda)[1] == "streamed"
    assert fps.plan(9096, 27, cuda)[1] == "registers"


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k,keep_last", [(9096, 27, 5000, 4096), (9096, 27, 5000, None),
                                             (9097, 27, 5000, 4097), (1025, 5, 1025, None),
                                             (1, 3, 1, None), (9096, 87, 5000, 4096),
                                             (49153, 27, 500, 4096), (17000, 33, 300, None)])
def test_fps_kernel_matches_plain_version(cuda, n, d, k, keep_last):
    """Index for index equal to `reference_fps` (the same f32 sums in the same
    order), bit-identical on a repeat, no invalid point chosen: at the AEG's
    pool, phase 9's task width (D = 87), past the old 49,152-row limit and
    in the resident instance past the register one (D = 33)."""
    pts, valid = _fps_case(n, cuda, d, keep_last)
    start = torch.argmax(valid.to(torch.uint8))
    launches = fps.farthest_point_sampling.launches
    idx = fps.farthest_point_sampling(pts, k, valid, start)
    again = fps.farthest_point_sampling(pts, k, valid, start)
    torch.cuda.synchronize()
    assert fps.farthest_point_sampling.launches == launches + 2
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (k,)
    assert torch.equal(idx, fps.reference_fps(pts, k, valid, start))
    assert torch.equal(idx, again)
    assert bool(valid[idx.long()].all()) or int(valid.sum()) < k


@pytest.mark.gpu
def test_fps_wrapper_rejects_bad_inputs(cuda):
    pts, valid = _fps_case(64, cuda)
    with pytest.raises(ValueError):
        fps.farthest_point_sampling(pts, 65, valid)
    with pytest.raises(ValueError):
        fps.farthest_point_sampling(pts.double(), 8, valid)
    with pytest.raises(ValueError):
        fps.farthest_point_sampling(pts.t(), 8, valid)
    with pytest.raises(ValueError):
        fps.farthest_point_sampling(pts, 8, valid[:10])
    with pytest.raises(ValueError):
        fps.farthest_point_sampling(pts, 8, valid.float())
