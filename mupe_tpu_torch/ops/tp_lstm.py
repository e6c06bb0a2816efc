"""TP-net LSTM + head, forward and backward.

Counterpart of mupe_tpu/ops/tp_lstm.py.  Over canonical leaves
(wi [F, 4H], wh [H, 4H], b [4H], wfc [H, O], bfc [O], gates in (i, f, g, o)
order, as `extract_tp_leaves` gives them), `tp_forward` maps history windows
[..., T, F] to tanh predictions [..., O]: on CPU tensors through
`reference_forward`, the plain version of `_fwd_steps_t` + `_head_t`
(tp_lstm.py:377-419); on CUDA tensors through the hand-written kernel in
`csrc/tp_lstm.cu` (the tensor-core warp tile of `csrc/tp_tile.cuh`).  It
is differentiable in the leaves: `tp_backward` (`reference_backward`, or two
kernel stages: `csrc/tp_lstm_bwd.cu`, the same tile's forward and the BPTT
of `_tp_bwd_kernel_t`, which stages the bf16 operands of the weight
products, then those products on `csrc/weight_grad.cu`) recomputes the
forward and sums the parameter gradients over the windows.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch

from ..utils import trace
from . import build
from . import fused_encoder as fe
from .fused_encoder import FLOOR_MULT, _bf16, _f32
from .tolerance import GradTol, KernelTol

# The limit of both TP-LSTM kernels (`kernel_spec_ok`): hidden width 64.
# Any F, T and O: up to 64 inputs and 64 outputs the register instances of
# `csrc/tp_tile.cuh`, past them its generic one (input k-tiles and output
# passes looped).
_KERNEL_HIDDEN = 64
_REGISTER_MAX_F = 64
_REGISTER_MAX_O = 64
# Kernel vs `reference_forward` and, per gradient leaf, the backward's two
# stages vs `reference_backward` (see tolerance.py): with the plain version
# in f64 given (`tolerance.in_f64`), each limit is at least FLOOR_MULT times
# the f32 plain version's own error against it.  Survey on an H100
# (scripts/torch_tolerance_survey.py, 12 seeds x N = 241,664 / 241,665 of
# the main shape, 4 of F 34, T 20, O 30): the forward's mean error reached
# 1.32x its floor, the f32 control's stayed above 29x its limit; per
# gradient leaf the kernel reached 1.62x the floor, the control stayed above
# 37.7x it.  The output bias's gradient meets no rounding point but y: the
# control's error there (1.5e-4 and up) passes the base mean limit, so it
# keeps the max check (BWD_CONTROL_BLIND).  A base of 5e-5 would catch it,
# but failed the kernel at N = 15 of the limit shape (F 64, T 32, O 64),
# where the floor is small and one flip moves a leaf's mean.
KERNEL_TOL = KernelTol(max_rel=5e-3, mean_rel=1e-4, floor_mult=FLOOR_MULT)
BWD_KERNEL_TOL = GradTol(max_rel=1e-2, mean_rel=3e-4, floor_mult=FLOOR_MULT)
BWD_CONTROL_BLIND = (-1,)


@dataclasses.dataclass(frozen=True)
class TPLSTMSpec:
    input_dim: int  # F (tp_input_dim, 16 for HideAndSeek)
    hidden: int     # 64
    t_steps: int    # history window length (10)
    out_dim: int    # 3 * future_prediction_step (15)

    def leaf_shapes(self):
        f, h, o = self.input_dim, self.hidden, self.out_dim
        return ((f, 4 * h), (h, 4 * h), (4 * h,), (h, o), (o,))


def reference_forward(
    spec: TPLSTMSpec,
    leaves: Sequence[torch.Tensor],
    x: torch.Tensor,
    *,
    bf16: bool = True,
) -> torch.Tensor:
    """x [N, T, F] f32 → [N, O]: bf16 matmul operands, f32 gates and state.
    bf16=False skips the rounding: the control that `KERNEL_TOL` must reject."""
    rnd = _bf16 if bf16 else _f32
    wi, wh, b, wfc, bfc = leaves
    n, hd = x.shape[0], spec.hidden
    h = torch.zeros((n, hd), dtype=x.dtype, device=x.device)
    c = torch.zeros_like(h)
    wi_b, wh_b = rnd(wi), rnd(wh)
    for t in range(spec.t_steps):
        g = (rnd(x[:, t]) @ wi_b + rnd(h) @ wh_b) + b
        gi = torch.sigmoid(g[:, :hd])
        gf = torch.sigmoid(g[:, hd : 2 * hd])
        gg = torch.tanh(g[:, 2 * hd : 3 * hd])
        go = torch.sigmoid(g[:, 3 * hd :])
        c = gf * c + gi * gg
        h = go * torch.tanh(c)
    return torch.tanh(rnd(h) @ rnd(wfc) + bfc)


def kernel_spec_ok(spec: TPLSTMSpec) -> bool:
    """Whether the TP-LSTM kernels (forward and backward) take `spec`: hidden
    width 64, any number (at least 1) of inputs, steps and outputs."""
    return (spec.hidden == _KERNEL_HIDDEN and spec.input_dim >= 1 and spec.t_steps >= 1
            and spec.out_dim >= 1)


def register_spec_ok(spec: TPLSTMSpec) -> bool:
    """Whether a spec the kernels take runs their register instances (at
    most 64 inputs and 64 outputs); past it the generic instance runs."""
    return spec.input_dim <= _REGISTER_MAX_F and spec.out_dim <= _REGISTER_MAX_O


def _check_spec(spec: TPLSTMSpec) -> None:
    if not kernel_spec_ok(spec):
        raise ValueError(
            f"spec exceeds the TP-LSTM kernels' limits (hidden {_KERNEL_HIDDEN}, at least "
            f"one input, step and output): {spec}")


def _check_kernel_args(spec: TPLSTMSpec, leaves, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"TP-LSTM kernel takes CUDA tensors, got {x.device}")
    _check_spec(spec)
    want = (spec.t_steps, spec.input_dim)
    if (
        x.dtype != torch.float32
        or x.dim() != 3
        or tuple(x.shape[1:]) != want
        or not x.is_contiguous()
    ):
        raise ValueError(
            f"x must be contiguous float32 [N, {want[0]}, {want[1]}], got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    if len(leaves) != 5:
        raise ValueError(f"want 5 leaves, got {len(leaves)}")
    for i, (leaf, shape) in enumerate(zip(leaves, spec.leaf_shapes())):
        if (
            tuple(leaf.shape) != shape
            or leaf.dtype != torch.float32
            or leaf.device != x.device
            or not leaf.is_contiguous()
        ):
            raise ValueError(
                f"leaf {i}: want contiguous float32 {shape} on {x.device}, "
                f"got {leaf.dtype} {tuple(leaf.shape)} on {leaf.device}"
            )


def _launch(spec: TPLSTMSpec, leaves, x: torch.Tensor) -> torch.Tensor:
    _check_kernel_args(spec, leaves, x)
    n = x.shape[0]
    y = torch.empty((n, spec.out_dim), device=x.device, dtype=torch.float32)
    wi, wh, b, wfc, bfc = leaves
    lib = build.library()
    with torch.cuda.device(x.device):
        trace.launching()
        err = lib.mupe_tp_lstm_forward(
            x.data_ptr(), n, spec.t_steps, spec.input_dim,
            wi.data_ptr(), wh.data_ptr(), b.data_ptr(), wfc.data_ptr(),
            bfc.data_ptr(), spec.out_dim, y.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(err, "mupe_tp_lstm_forward")
    return y


def reference_backward(
    spec: TPLSTMSpec,
    leaves: Sequence[torch.Tensor],
    x: torch.Tensor,
    dy: torch.Tensor,
    *,
    bf16: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """Gradients of sum(y · dy) for (wi, wh, b, wfc, bfc), summed over the
    windows: `_tp_bwd_kernel_t`'s recompute + BPTT (tp_lstm.py:428-505) in
    the [N, T, F] layout.  dz and every step's gate gradient are rounded to
    bf16 before they meet a matmul; db and dbfc are f32 sums of the
    unrounded values.  bf16=False skips the rounding: the control that
    `BWD_KERNEL_TOL` must reject."""
    rnd = _bf16 if bf16 else _f32
    wi, wh, b, wfc, bfc = leaves
    n, hd = x.shape[0], spec.hidden
    h = torch.zeros((n, hd), dtype=x.dtype, device=x.device)
    c = torch.zeros_like(h)
    wi_b, wh_b = rnd(wi), rnd(wh)
    acts, cs, hs = [], [c], [h]
    for t in range(spec.t_steps):
        g = (rnd(x[:, t]) @ wi_b + rnd(h) @ wh_b) + b
        gi = torch.sigmoid(g[:, :hd])
        gf = torch.sigmoid(g[:, hd : 2 * hd])
        gg = torch.tanh(g[:, 2 * hd : 3 * hd])
        go = torch.sigmoid(g[:, 3 * hd :])
        c = gf * c + gi * gg
        h = go * torch.tanh(c)
        acts.append((gi, gf, gg, go))
        cs.append(c)
        hs.append(h)
    y = torch.tanh(rnd(h) @ rnd(wfc) + bfc)
    dz = dy.to(x.dtype) * (1.0 - y * y)
    dzb = rnd(dz)
    dwfc = rnd(h).T @ dzb
    dbfc = dz.sum(0)
    dh = dzb @ rnd(wfc).T
    dc = torch.zeros_like(dh)
    dwi, dwh, db = torch.zeros_like(wi), torch.zeros_like(wh), torch.zeros_like(b)
    for t in reversed(range(spec.t_steps)):
        gi, gf, gg, go = acts[t]
        tc = torch.tanh(cs[t + 1])
        do = dh * tc
        dc = dc + dh * go * (1.0 - tc * tc)
        di = dc * gg
        dgg = dc * gi
        df = dc * cs[t]
        dc = dc * gf
        dg = torch.cat([di * gi * (1.0 - gi), df * gf * (1.0 - gf),
                        dgg * (1.0 - gg * gg), do * go * (1.0 - go)], dim=1)
        db = db + dg.sum(0)
        dgb = rnd(dg)
        dwh = dwh + rnd(hs[t]).T @ dgb
        dwi = dwi + rnd(x[:, t]).T @ dgb
        dh = dgb @ wh_b.T
    return dwi, dwh, db, dwfc, dbfc


# The backward's staging for a chunk of windows: every step's bf16 x_t
# (its columns padded to 16 with zeros), h_t and gate cotangent dg_t, the
# head's bf16 dz (its columns padded to 8), each with the chunk's windows
# padded to a multiple of STAGE_ROWS (stage B's K step; the padding windows'
# dg and dz are zeros), and stage A's f32 c of every step.  A chunk takes at
# most STAGING_CAP bytes: a call with more windows runs both stages chunk by
# chunk and adds the chunks' gradients in order.
STAGE_ROWS = 32
STAGING_CAP = 2 ** 31
_TILE = 128  # the weight-gradient kernel's M and N


def _fk(f: int) -> int:
    return -(-f // 16) * 16


def _op(o: int) -> int:
    return -(-o // 8) * 8


def staged_rows(n: int) -> int:
    return -(-n // STAGE_ROWS) * STAGE_ROWS


def _staging_shapes(spec: TPLSTMSpec, n_pad: int):
    t, g = spec.t_steps, 4 * spec.hidden
    return {"x": (t, n_pad, _fk(spec.input_dim)), "h": (t, n_pad, spec.hidden),
            "dg": (t, n_pad, g), "dz": (n_pad, _op(spec.out_dim))}


def _window_bytes(spec: TPLSTMSpec) -> int:
    """Staged bytes a window: the bf16 operands and the f32 c of every step."""
    per = sum(math.prod(sh) for sh in _staging_shapes(spec, 1).values())
    return 2 * per + 4 * spec.t_steps * spec.hidden


def window_chunks(spec: TPLSTMSpec, n: int) -> Tuple[Tuple[int, int], ...]:
    """The backward's chunks of n windows, [start, stop) each: as few as
    STAGING_CAP allows, of equal size (a multiple of STAGE_ROWS) but the last."""
    per = max(STAGE_ROWS, STAGING_CAP // _window_bytes(spec) // STAGE_ROWS * STAGE_ROWS)
    size = staged_rows(-(-n // max(1, -(-n // per))))
    return tuple((s, min(s + size, n)) for s in range(0, n, size))


def staging_bytes(spec: TPLSTMSpec, n: int) -> int:
    """Bytes of the backward's staging for a call of n windows (its largest
    chunk's)."""
    chunks = window_chunks(spec, n)
    return staged_rows(max((b - a for a, b in chunks), default=0)) * _window_bytes(spec)


def _leaf_offsets(spec: TPLSTMSpec) -> Tuple[int, ...]:
    sizes = [math.prod(s) for s in spec.leaf_shapes()]
    return tuple(sum(sizes[:i]) for i in range(len(sizes) + 1))


def reference_backward_operands(
    spec: TPLSTMSpec,
    leaves: Sequence[torch.Tensor],
    x: torch.Tensor,
    dy: torch.Tensor,
    *,
    bf16: bool = True,
):
    """Stage A of the backward in plain PyTorch: `reference_backward`
    without its weight products.  Returns (staged, sums):

    * staged: the operands of the weight products, rounded as the products
      round them (bf16 values): "x" [T, N, F] x_t, "h" [T, N, H] h_1 .. h_T,
      "dg" [T, N, 4H] every step's gate cotangent, "dz" [N, O];
    * sums: {2: db, 4: dbfc}, f32 sums of the unrounded values.

    bf16=False skips every rounding point (the control)."""
    rnd = _bf16 if bf16 else _f32
    wi, wh, b, wfc, bfc = leaves
    n, hd = x.shape[0], spec.hidden
    h = torch.zeros((n, hd), dtype=x.dtype, device=x.device)
    c = torch.zeros_like(h)
    wi_b, wh_b = rnd(wi), rnd(wh)
    acts, cs, hs = [], [c], []
    for t in range(spec.t_steps):
        g = (rnd(x[:, t]) @ wi_b + rnd(h) @ wh_b) + b
        gi = torch.sigmoid(g[:, :hd])
        gf = torch.sigmoid(g[:, hd : 2 * hd])
        gg = torch.tanh(g[:, 2 * hd : 3 * hd])
        go = torch.sigmoid(g[:, 3 * hd :])
        c = gf * c + gi * gg
        h = go * torch.tanh(c)
        acts.append((gi, gf, gg, go))
        cs.append(c)
        hs.append(h)
    y = torch.tanh(rnd(h) @ rnd(wfc) + bfc)
    dz = dy.to(x.dtype) * (1.0 - y * y)
    dh = rnd(dz) @ rnd(wfc).T
    dc = torch.zeros_like(dh)
    db = torch.zeros_like(b)
    dgs = [None] * spec.t_steps
    for t in reversed(range(spec.t_steps)):
        gi, gf, gg, go = acts[t]
        tc = torch.tanh(cs[t + 1])
        do = dh * tc
        dc = dc + dh * go * (1.0 - tc * tc)
        di = dc * gg
        dgg = dc * gi
        df = dc * cs[t]
        dc = dc * gf
        dg = torch.cat([di * gi * (1.0 - gi), df * gf * (1.0 - gf),
                        dgg * (1.0 - gg * gg), do * go * (1.0 - go)], dim=1)
        db = db + dg.sum(0)
        dgs[t] = rnd(dg)
        dh = dgs[t] @ wh_b.T
    staged = {"x": rnd(x).transpose(0, 1), "h": rnd(torch.stack(hs)), "dg": torch.stack(dgs),
              "dz": rnd(dz)}
    return staged, {2: db, 4: dz.sum(0)}


def reference_weight_grads(spec: TPLSTMSpec, staged) -> Dict[int, torch.Tensor]:
    """Stage B of the backward in plain PyTorch: the weight products from the
    staged operands (f32 products and sums of their values) -> {0: dwi, 1:
    dwh, 3: dwfc}.  Takes `reference_backward_operands`' staging or the
    kernel's (bf16; padding windows with zero dg and dz, x's and dz's
    columns zero-padded)."""
    f, hd, o = spec.input_dim, spec.hidden, spec.out_dim
    up = lambda t: t.to(torch.promote_types(t.dtype, torch.float32))  # noqa: E731
    x, h, dg, dz = (up(staged[k]) for k in ("x", "h", "dg", "dz"))
    g = dg.shape[-1]
    return {0: x[..., :f].reshape(-1, f).T @ dg.reshape(-1, g),
            1: h[:-1].reshape(-1, hd).T @ dg[1:].reshape(-1, g),
            3: h[-1].T @ dz[:, :o]}


def _alloc_staging(spec: TPLSTMSpec, n_pad: int, device):
    """One bf16 buffer carved into the staged operands (`_staging_shapes`)
    and the f32 c scratch of stage A, for n_pad windows."""
    shapes = _staging_shapes(spec, n_pad)
    sizes = [math.prod(sh) for sh in shapes.values()]
    flat = torch.empty(sum(sizes), dtype=torch.bfloat16, device=device)
    staged = {k: p.view(sh) for (k, sh), p in zip(shapes.items(), torch.split(flat, sizes))}
    cs = torch.empty(n_pad * spec.t_steps * spec.hidden, dtype=torch.float32, device=device)
    return staged, cs


def _launch_operands(spec: TPLSTMSpec, leaves, x: torch.Tensor, dy: torch.Tensor, flat, staged,
                     cs) -> None:
    """Stage A for the windows of x (one chunk): the staging, and db and
    dbfc into the flat gradient vector."""
    n, n_pad = x.shape[0], staged["dz"].shape[0]
    offs = _leaf_offsets(spec)
    wi, wh, b, wfc, bfc = leaves
    lib = build.library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        build.check(lib.mupe_tp_lstm_bwd_blocks(n_pad, spec.t_steps, spec.input_dim, spec.out_dim,
                                                ctypes.byref(blocks)), "mupe_tp_lstm_bwd_blocks")
        ws = torch.empty(blocks.value * (4 * spec.hidden + spec.out_dim), device=x.device,
                         dtype=torch.float32)
        trace.launching()
        err = lib.mupe_tp_lstm_bwd_operands(
            x.data_ptr(), dy.data_ptr(), n, n_pad, spec.t_steps, spec.input_dim,
            wi.data_ptr(), wh.data_ptr(), b.data_ptr(), wfc.data_ptr(), bfc.data_ptr(),
            spec.out_dim, staged["x"].data_ptr(), staged["h"].data_ptr(),
            staged["dg"].data_ptr(), staged["dz"].data_ptr(), cs.data_ptr(),
            flat.data_ptr() + 4 * offs[2], flat.data_ptr() + 4 * offs[4], ws.data_ptr(),
            blocks.value, torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(err, "mupe_tp_lstm_bwd_operands")


# Stage B splits each TP product's K (T x the chunk's windows, ~1.2M rows at
# the update's shape) over STAGE_B_BLOCKS blocks, about one an SM, so that a
# block's K loop is long and its partial products few (the encoder's
# 2,048-row chunks would give ~600 a product, summed one by one).
STAGE_B_BLOCKS = 128


def stage_b_chunk(k_rows: int) -> int:
    """Rows a stage-B block takes of a TP product's k_rows staged rows."""
    bounds = fe.split_k(k_rows, STAGE_B_BLOCKS, STAGE_ROWS)
    return bounds[0][1] - bounds[0][0] if bounds else STAGE_ROWS


def tp_weight_grads(spec: TPLSTMSpec, staged, flat: torch.Tensor) -> None:
    """Stage B of the backward: dwi, dwh and dwfc from the staged operands,
    written into the flat gradient vector.  On CPU tensors
    `reference_weight_grads`; on CUDA tensors one launch of the split-K
    kernel in `csrc/weight_grad.cu` (+ its fixed-order sum of the partial
    products), the gate cotangents as two 128-column halves."""
    offs = _leaf_offsets(spec)
    if flat.device.type == "cpu":
        for i, g in reference_weight_grads(spec, staged).items():
            flat[offs[i] : offs[i + 1]].copy_(g.reshape(-1))
        return
    t, g, hd = spec.t_steps, 4 * spec.hidden, spec.hidden
    n_pad = staged["dz"].shape[0]
    if tuple(staged["dg"].shape) != (t, n_pad, g):
        raise ValueError(f"staged dg of shape {tuple(staged['dg'].shape)}, want {(t, n_pad, g)}")
    xs, hs, dg, dz = (staged[k].data_ptr() for k in ("x", "h", "dg", "dz"))
    out = lambda i, col=0: flat.data_ptr() + 4 * (offs[i] + col)  # noqa: E731
    half, f, fk, o = g // 2, spec.input_dim, _fk(spec.input_dim), spec.out_dim
    prods = []
    for col in (0, half):
        for r in range(0, fk, _TILE):  # x's columns (dwi's rows), 128 a product
            prods.append(fe.WeightProduct(xs + 2 * r, dg + 2 * col, min(_TILE, fk - r),
                                          min(_TILE, f - r), g, half, g, t * n_pad,
                                          out(0, r * g + col), fk))
        prods.append(fe.WeightProduct(hs, dg + 2 * (n_pad * g + col), hd, hd, g, half, g,
                                      (t - 1) * n_pad, out(1, col)))
    op = _op(o)
    # dwfc [H, O], dz's columns 128 a product: past one product, into a
    # [H, op] buffer (a product writes whole column blocks) and copied out
    wfc = flat if op <= _TILE else torch.empty((hd, op), device=flat.device, dtype=torch.float32)
    at = out(3) if op <= _TILE else wfc.data_ptr()
    for c in range(0, op, _TILE):
        prods.append(fe.WeightProduct(hs + 2 * (t - 1) * n_pad * hd, dz + 2 * c, hd, hd, op,
                                      min(_TILE, op - c), o if op <= _TILE else op, n_pad,
                                      at + 4 * c))
    with trace.span("kernel.tp_weight_grad"):
        fe.launch_weight_products(prods, flat.device, stage_b_chunk)
    if op > _TILE:
        flat[offs[3] : offs[4]].view(hd, o).copy_(wfc[:, :o])


def chunk_plan(spec: TPLSTMSpec, x: torch.Tensor, dy: torch.Tensor):
    """The backward's chunks of windows (`window_chunks`): [(x, dy, staging,
    c scratch)] of each, views of one staging allocated for the largest."""
    chunks = window_chunks(spec, x.shape[0]) or ((0, 0),)
    staged_all, cs = _alloc_staging(spec, staged_rows(chunks[0][1] - chunks[0][0]), x.device)
    plan = []
    for a, b in chunks:
        shapes = _staging_shapes(spec, staged_rows(b - a))
        staged = {k: v.reshape(-1)[: math.prod(sh)].view(sh)
                  for (k, sh), v in zip(shapes.items(), staged_all.values())}
        plan.append((x[a:b], dy[a:b], staged, cs))
    return plan


def tp_backward(
    spec: TPLSTMSpec, leaves: Sequence[torch.Tensor], x: torch.Tensor, dy: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Gradients of sum(y · dy) for (wi, wh, b, wfc, bfc) over windows
    x [N, T, F] and cotangents dy [N, O]: on CPU tensors
    `reference_backward`, on CUDA tensors two stages a chunk of windows
    (`window_chunks`): the tile kernel of `csrc/tp_lstm_bwd.cu`, then
    `tp_weight_grads` (views of one flat gradient vector), both in the span
    `kernel.tp_bwd`."""
    if x.device.type == "cpu":
        return reference_backward(spec, leaves, x, dy)
    x, dy = x.contiguous(), dy.contiguous()
    _check_kernel_args(spec, leaves, x)
    n = x.shape[0]
    if dy.device != x.device or dy.dtype != torch.float32 or tuple(dy.shape) != (n, spec.out_dim):
        raise ValueError(f"dy must be float32 [{n}, {spec.out_dim}] on {x.device}, "
                         f"got {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    total = None
    for xa, dya, staged, cs in chunk_plan(spec, x, dy):
        flat = torch.empty(_leaf_offsets(spec)[-1], device=x.device, dtype=torch.float32)
        with trace.span("kernel.tp_bwd"):
            _launch_operands(spec, leaves, xa, dya, flat, staged, cs)
            tp_weight_grads(spec, staged, flat)
        total = flat if total is None else total.add_(flat)
    shapes = spec.leaf_shapes()
    parts = torch.split(total, [math.prod(s) for s in shapes])
    return tuple(p.view(s) for p, s in zip(parts, shapes))


class _TPFn(torch.autograd.Function):
    """TP forward; the backward recomputes it from x and the leaves and
    returns no gradient for x (windows are data)."""

    @staticmethod
    def forward(ctx, spec, x, *leaves):
        ctx.spec = spec
        ctx.save_for_backward(x, *leaves)
        if x.device.type == "cpu":
            return reference_forward(spec, leaves, x)
        with trace.span("kernel.tp_fwd"):
            return _launch(spec, leaves, x)

    @staticmethod
    def backward(ctx, dy):
        x, *leaves = ctx.saved_tensors
        return (None, None) + tuple(tp_backward(ctx.spec, leaves, x, dy))


def tp_forward(
    spec: TPLSTMSpec, leaves: Sequence[torch.Tensor], x: torch.Tensor
) -> torch.Tensor:
    """Windows [..., T, F] → tanh predictions [..., O]; differentiable in
    the leaves.  Raises ValueError, on either device, for windows of another
    length or width than `spec`'s."""
    if x.dim() < 2 or tuple(x.shape[-2:]) != (spec.t_steps, spec.input_dim):
        raise ValueError(f"windows must be [..., {spec.t_steps}, {spec.input_dim}], "
                         f"got {tuple(x.shape)}")
    batch_shape = tuple(x.shape[:-2])
    xf = x.reshape((-1,) + tuple(x.shape[-2:]))
    if xf.device.type != "cpu":
        xf = xf.contiguous()
    y = _TPFn.apply(spec, xf, *leaves)
    return y.reshape(batch_shape + (spec.out_dim,))
