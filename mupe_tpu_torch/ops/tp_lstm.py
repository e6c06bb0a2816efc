"""TP-net LSTM + head, forward and backward.

Counterpart of mupe_tpu/ops/tp_lstm.py.  Over canonical leaves
(wi [F, 4H], wh [H, 4H], b [4H], wfc [H, O], bfc [O], gates in (i, f, g, o)
order, as `extract_tp_leaves` gives them), `tp_forward` maps history windows
[..., T, F] to tanh predictions [..., O]: on CPU tensors through
`reference_forward`, the plain version of `_fwd_steps_t` + `_head_t`
(tp_lstm.py:377-419); on CUDA tensors through the hand-written kernel in
`csrc/tp_lstm.cu`.  It is differentiable in the leaves: `tp_backward`
(`reference_backward`, or the kernel in `csrc/tp_lstm_bwd.cu`) recomputes
the forward and runs the BPTT of `_tp_bwd_kernel_t`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Sequence, Tuple

import torch

from . import build
from .fused_encoder import _bf16, _f32
from .tolerance import GradTol, KernelTol

# The limits of both TP-LSTM kernels (`kernel_spec_ok`).
_KERNEL_HIDDEN = 64
_KERNEL_MAX_F = 64
_KERNEL_MAX_T = 32
_KERNEL_MAX_O = 64
# Kernel vs `reference_forward` (see tolerance.py).
KERNEL_TOL = KernelTol(max_rel=5e-3, mean_rel=1e-4)
# Backward kernel vs `reference_backward`, per gradient leaf.  On an H100 at
# N = 241,664 the kernel's mean error reached 5.3e-5 of a leaf's mean, the f32
# control's stayed above 3.2e-3, except on the output bias (2.7e-4: its
# gradient meets no rounding point but y), which the control passes and
# which keeps the max check (BWD_CONTROL_BLIND).
BWD_KERNEL_TOL = GradTol(max_rel=1e-2, mean_rel=3e-4)
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
    width 64, 1-64 inputs, 1-32 steps, 1-64 outputs."""
    return (spec.hidden == _KERNEL_HIDDEN and 1 <= spec.input_dim <= _KERNEL_MAX_F
            and 1 <= spec.t_steps <= _KERNEL_MAX_T and 1 <= spec.out_dim <= _KERNEL_MAX_O)


def _check_spec(spec: TPLSTMSpec) -> None:
    if not kernel_spec_ok(spec):
        raise ValueError(
            f"spec exceeds the TP-LSTM kernels' limits (hidden {_KERNEL_HIDDEN}, at most "
            f"{_KERNEL_MAX_F} inputs, {_KERNEL_MAX_T} steps, {_KERNEL_MAX_O} outputs): {spec}")


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


def _launch_bwd(spec: TPLSTMSpec, leaves, x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    _check_kernel_args(spec, leaves, x)
    n = x.shape[0]
    if (dy.device != x.device or dy.dtype != torch.float32 or not dy.is_contiguous()
            or tuple(dy.shape) != (n, spec.out_dim)):
        raise ValueError(f"dy must be contiguous float32 [{n}, {spec.out_dim}] on {x.device}, "
                         f"got {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    size = sum(math.prod(s) for s in spec.leaf_shapes())
    grad = torch.empty(size, device=x.device, dtype=torch.float32)
    wi, wh, b, wfc, bfc = leaves
    lib = build.library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        build.check(lib.mupe_tp_lstm_backward_blocks(
            n, spec.t_steps, spec.input_dim, spec.out_dim, ctypes.byref(blocks)),
                    "mupe_tp_lstm_backward_blocks")
        ws = torch.empty(blocks.value * size, device=x.device, dtype=torch.float32)
        err = lib.mupe_tp_lstm_backward(
            x.data_ptr(), dy.data_ptr(), n, spec.t_steps, spec.input_dim,
            wi.data_ptr(), wh.data_ptr(), b.data_ptr(), wfc.data_ptr(), bfc.data_ptr(),
            spec.out_dim, grad.data_ptr(), ws.data_ptr(), blocks.value,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(err, "mupe_tp_lstm_backward")
    return grad


def tp_backward(
    spec: TPLSTMSpec, leaves: Sequence[torch.Tensor], x: torch.Tensor, dy: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Gradients of sum(y · dy) for (wi, wh, b, wfc, bfc) over windows
    x [N, T, F] and cotangents dy [N, O]: on CPU tensors
    `reference_backward`, on CUDA tensors the kernel in `csrc/tp_lstm_bwd.cu`
    (views of one flat gradient vector)."""
    if x.device.type == "cpu":
        return reference_backward(spec, leaves, x, dy)
    flat = _launch_bwd(spec, leaves, x.contiguous(), dy.contiguous())
    tp_backward.launches += 1
    shapes = spec.leaf_shapes()
    parts = torch.split(flat, [math.prod(s) for s in shapes])
    return tuple(p.view(s) for p, s in zip(parts, shapes))


tp_backward.launches = 0


class _TPFn(torch.autograd.Function):
    """TP forward; the backward recomputes it from x and the leaves and
    returns no gradient for x (windows are data)."""

    @staticmethod
    def forward(ctx, spec, x, *leaves):
        ctx.spec = spec
        ctx.save_for_backward(x, *leaves)
        if x.device.type == "cpu":
            return reference_forward(spec, leaves, x)
        y = _launch(spec, leaves, x)
        tp_forward.launches += 1
        return y

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


tp_forward.launches = 0
