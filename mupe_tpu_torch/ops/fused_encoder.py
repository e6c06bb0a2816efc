"""Encoder + linear head, forward and backward, for one network or an
actor+critic pair.

Counterpart of mupe_tpu/ops/fused_encoder.py.  The network is the
PartialAttentionEncoder with a linear head, over a canonical tuple of
parameter leaves (`leaf_shapes`); its plain PyTorch version is
`reference_apply`, which is `_forward_core` (fused_encoder.py:278-364) with
the same bf16 rounding points.  `encoder_forward` and `encoder_pair_forward`
run it on packed observation rows: on CPU tensors through `reference_apply`,
on CUDA tensors through the hand-written kernel in `csrc/fused_encoder.cu`
(one launch for one or both networks).  Both are differentiable in the
leaves: `encoder_backward` (`reference_backward`, the plain version of
`_backward_core`, or the kernel in `csrc/fused_encoder_bwd.cu`) recomputes
the forward and sums the parameter gradients over the rows.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch

from . import build
from .tolerance import GradTol, KernelTol

_LN_EPS = 1e-6  # flax LayerNorm default
_KERNEL_WIDTH = 128  # the kernel's embed and feed-forward width
_KERNEL_MAX_TOKENS = 8
_KERNEL_MAX_GROUPS = 4
_KERNEL_MAX_OBS = 128
_KERNEL_MAX_HEAD = 8
# Kernel vs `reference_apply` (see tolerance.py).
KERNEL_TOL = KernelTol(max_rel=5e-3, mean_rel=1e-4)
# Backward kernel vs `reference_backward`, per gradient leaf, for sums over
# the main path's tens of thousands of rows; the key bias gradient (15th leaf
# from the end) is analytically zero (see tolerance.py).  On an H100 at
# S = 49,152 the kernel's mean error reached 8.4e-4 of a leaf's mean, the f32
# control's stayed above 2.3e-3, except on the leaves of BWD_CONTROL_BLIND,
# which the control passes (and which keep the max check): the key bias
# (noise), the second FFN bias and LN2's bias (1.4e-3 to 1.5e-3: their
# gradients meet one rounding point) and the head bias (no rounding point).
BWD_KERNEL_TOL = GradTol(max_rel=1e-2, mean_rel=1.5e-3, noise_floor=1e-4, noise_leaves=(-15,))
BWD_CONTROL_BLIND = (-15, -5, -3, -1)
# The forward + loss kernels' stats [S, 9 + A] vs `reference_loss_math`'s,
# column by column: KERNEL_TOL's mean limit, and twice its max limit, for the
# columns that carry the log-ratio (ratio, ratio², the clamped log-ratio,
# min(surr1, surr2), the dlog_std columns): a row's log-prob error is the
# actor's output error times |act - mean| / sigma² (up to ~10x at sigma =
# e^-1), and ratio² doubles the ratio's relative error.  Measured on an H100
# at S = 49,152: 5.2e-3 on ratio², mean errors under 1e-5.
LOSS_STATS_TOL = KernelTol(max_rel=1e-2, mean_rel=1e-4)


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    """Static description of one encoder+head instance.

    groups: per entity group (in canonical order) the (num_tokens, feat_dim).
    """

    groups: Tuple[Tuple[int, int], ...]
    head_dim: int
    embed_dim: int = 128
    ff_dim: int = 128

    @property
    def n_tokens(self) -> int:
        return sum(k for k, _ in self.groups)

    @property
    def obs_dim(self) -> int:
        return sum(k * d for k, d in self.groups)

    @property
    def n_leaves(self) -> int:
        return 2 * len(self.groups) + 20


def leaf_shapes(spec: EncoderSpec) -> Tuple[Tuple[int, ...], ...]:
    """Shapes of the canonical leaves (order of `extract_leaves`,
    mupe_tpu/ops/fused_encoder.py:110-143): per group (Wg, bg), ln0
    (scale, bias), Wq, bq, Wk, bk, Wv, bv, Wo, bo, ln1, W1, b1, W2, b2, ln2,
    Wh, bh.  Weights are [in, out]."""
    e, f, h = spec.embed_dim, spec.ff_dim, spec.head_dim
    shapes = []
    for _, d in spec.groups:
        shapes += [(d, e), (e,)]
    shapes += [(e,), (e,)]
    shapes += [(e, e), (e,)] * 4
    shapes += [(e,), (e,), (e, f), (f,), (f, e), (e,), (e,), (e,), (e, h), (h,)]
    return tuple(shapes)


def pack_obs(spec: EncoderSpec, obs: Dict[str, torch.Tensor], group_names):
    """Dict of [..., k, d] groups → ([S, obs_dim] rows in canonical order,
    leading shape)."""
    lead = tuple(obs[group_names[0]].shape[:-2])
    parts = [
        obs[name].reshape(-1, k * d)
        for name, (k, d) in zip(group_names, spec.groups)
    ]
    return torch.cat(parts, dim=-1), lead


# ---------------------------------------------------------------- plain version
def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x


def _gelu_tanh(x):
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def _ln_parts(x, scale, bias):
    """LayerNorm → (out, n, inv) as `_ln_f32` of the JAX package returns them."""
    x = x.to(torch.float32)
    m = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - m * m
    inv = torch.rsqrt(var + _LN_EPS)
    n = (x - m) * inv
    return n * scale + bias, n, inv


def _dgelu_tanh(x):
    c = math.sqrt(2.0 / math.pi)
    t = torch.tanh(c * (x + 0.044715 * x * x * x))
    dinner = c * (1.0 + 3.0 * 0.044715 * x * x)
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * dinner


def _unpack_leaves(spec: EncoderSpec, leaves):
    it = iter(leaves)
    gw = [(next(it), next(it)) for _ in spec.groups]
    rest = [next(it) for _ in range(20)]
    return gw, rest


def _forward_res(spec: EncoderSpec, leaves, x, rnd):
    """`_forward_core` (fused_encoder.py:278-364): output and the residuals
    its backward reads, at the same rounding points."""

    def mm(a, b):  # bf16 operands, f32 products and sums (`_mm` of the JAX package)
        return rnd(a) @ rnd(b)

    gw, (g0, b0, wq, bq, wk, bk, wv, bv, wo, bo, g1, b1, w1, bf1, w2, bf2,
         g2, b2, wh, bh) = _unpack_leaves(spec, leaves)
    es, xs = [], []
    off = 0
    for (k, d), (wg, bg) in zip(spec.groups, gw):
        for _ in range(k):
            xt = x[:, off : off + d]
            es.append(rnd(mm(xt, wg) + bg))
            xs.append(xt)
            off += d
    e_all = torch.stack(es)                        # [n_tok, S, E] bf16 values
    h_f32, n0_all, inv0_all = _ln_parts(e_all, g0, b0)
    h_all = rnd(h_f32)
    h0 = h_f32[0]
    q = mm(h0, wq) + bq                            # [S, E] f32
    ks_all = rnd(mm(h_all, wk) + bk)
    vs_all = rnd(mm(h_all, wv) + bv)
    scale = 1.0 / math.sqrt(spec.embed_dim)
    s = (q[None] * ks_all).sum(-1) * scale         # [n_tok, S]
    e = torch.exp(s - s.max(0, keepdim=True).values)
    a = e * (1.0 / e.sum(0, keepdim=True))
    att = (a[..., None] * vs_all).sum(0)           # [S, E]
    r1 = h0 + (mm(att, wo) + bo)
    y1, n1, inv1 = _ln_parts(r1, g1, b1)
    pre1 = mm(y1, w1) + bf1
    f = _gelu_tanh(pre1)
    r2 = y1 + (mm(f, w2) + bf2)
    y2, n2, inv2 = _ln_parts(r2, g2, b2)
    out = mm(y2, wh) + bh
    res = dict(xs=xs, h_all=h_all, n0_all=rnd(n0_all), inv0_all=inv0_all, q=q,
               ks_all=ks_all, vs_all=vs_all, a=a, att=att, n1=n1, inv1=inv1,
               y1=y1, pre1=pre1, f=f, n2=n2, inv2=inv2, y2=y2)
    return out, res


def reference_apply(
    spec: EncoderSpec,
    leaves: Sequence[torch.Tensor],
    x: torch.Tensor,
    *,
    bf16: bool = True,
) -> torch.Tensor:
    """[S, obs_dim] f32 → [S, head_dim] f32, in plain PyTorch.

    Tokens are stacked on a leading axis ([n_tok, S, E]) rather than the
    TPU's row-stacked layout; the arithmetic and its rounding are those of
    `_forward_core`.  bf16=False skips every rounding point: the control
    that `KERNEL_TOL` must reject."""
    return _forward_res(spec, leaves, x, _bf16 if bf16 else _f32)[0]


def _ln_bwd(dy, n, inv, scale):
    dscale = (dy * n).sum(-2)
    dbias = dy.sum(-2)
    dn = dy * scale
    dx = inv * (dn - dn.mean(-1, keepdim=True) - n * (dn * n).mean(-1, keepdim=True))
    return dx, dscale, dbias


def reference_backward(
    spec: EncoderSpec,
    leaves: Sequence[torch.Tensor],
    x: torch.Tensor,
    dout: torch.Tensor,
    *,
    bf16: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """Gradients of sum(out · dout) for every leaf, summed over the rows, in
    plain PyTorch: `_forward_core` recomputed, then `_backward_core`
    (fused_encoder.py:377-463) at its rounding points (both operands of
    every `_mm_tn` / `_mm_nt` in bf16, dout included; dk and dv blocks in
    bf16; n0 in bf16; LayerNorm backward and the column sums in f32).
    Returns the gradients in the canonical leaf order.  bf16=False skips
    every rounding point: the control that `BWD_KERNEL_TOL` must reject."""
    rnd = _bf16 if bf16 else _f32

    def mm_tn(a, b):  # aᵀ b over the rows (and tokens)
        return rnd(a).reshape(-1, a.shape[-1]).T @ rnd(b).reshape(-1, b.shape[-1])

    def mm_nt(a, w):  # a wᵀ
        return rnd(a) @ rnd(w).T

    _, res = _forward_res(spec, leaves, x, rnd)
    gw, (g0, b0, wq, bq, wk, bk, wv, bv, wo, bo, g1, b1, w1, bf1, w2, bf2,
         g2, b2, wh, bh) = _unpack_leaves(spec, leaves)
    scale = 1.0 / math.sqrt(spec.embed_dim)
    dout = dout.to(x.dtype)

    dwh = mm_tn(res["y2"], dout)
    dbh = dout.sum(0)
    dy2 = mm_nt(dout, wh)
    dr2, dg2ln, db2ln = _ln_bwd(dy2, res["n2"], res["inv2"], g2)
    dw2 = mm_tn(res["f"], dr2)
    dbf2 = dr2.sum(0)
    dpre1 = mm_nt(dr2, w2) * _dgelu_tanh(res["pre1"])
    dw1 = mm_tn(res["y1"], dpre1)
    dbf1 = dpre1.sum(0)
    dy1 = dr2 + mm_nt(dpre1, w1)
    dr1, dg1ln, db1ln = _ln_bwd(dy1, res["n1"], res["inv1"], g1)
    dwo = mm_tn(res["att"], dr1)
    dbo = dr1.sum(0)
    datt = mm_nt(dr1, wo)
    a, q = res["a"], res["q"]                      # [n_tok, S], [S, E]
    das = (datt[None] * res["vs_all"]).sum(-1)     # [n_tok, S]
    wsum = a[0] * das[0]
    for t in range(1, spec.n_tokens):
        wsum = wsum + a[t] * das[t]
    dss = a * (das - wsum)
    dq = dss[0, :, None] * res["ks_all"][0]
    for t in range(1, spec.n_tokens):
        dq = dq + dss[t, :, None] * res["ks_all"][t]
    dq = dq * scale
    dks = rnd(dss[..., None] * q * scale)          # [n_tok, S, E]
    dvs = rnd(a[..., None] * datt)
    h_all = res["h_all"]
    dwq = mm_tn(h_all[0], dq)
    dbq = dq.sum(0)
    dwk = mm_tn(h_all, dks)
    dbk = dks.sum((0, 1))
    dwv = mm_tn(h_all, dvs)
    dbv = dvs.sum((0, 1))
    dh_all = mm_nt(dks, wk) + mm_nt(dvs, wv)
    dh0 = dh_all[0] + dr1 + mm_nt(dq, wq)
    dh_all = torch.cat([dh0[None], dh_all[1:]])
    de_all, dg0, db0 = _ln_bwd(dh_all, res["n0_all"], res["inv0_all"], g0)
    dg0, db0 = dg0.sum(0), db0.sum(0)
    dgw = []
    t = 0
    for (k, _), (wg, bg) in zip(spec.groups, gw):
        dwg = torch.zeros_like(wg)
        dbg = torch.zeros_like(bg)
        for _ in range(k):
            dwg = dwg + mm_tn(res["xs"][t], de_all[t])
            dbg = dbg + de_all[t].sum(0)
            t += 1
        dgw += [dwg, dbg]
    return tuple(dgw + [dg0, db0, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo,
                        dg1ln, db1ln, dw1, dbf1, dw2, dbf2, dg2ln, db2ln, dwh, dbh])


# ---------------------------------------------------------------- kernel
def _check_kernel_args(x: torch.Tensor, nets) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"encoder kernel takes CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            f"x must be contiguous float32 [S, obs_dim], got {x.dtype} "
            f"{tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    for spec, leaves in nets:
        if spec.embed_dim != _KERNEL_WIDTH or spec.ff_dim != _KERNEL_WIDTH:
            raise ValueError(f"kernel needs embed_dim = ff_dim = 128, got {spec}")
        if (
            spec.n_tokens > _KERNEL_MAX_TOKENS
            or len(spec.groups) > _KERNEL_MAX_GROUPS
            or spec.obs_dim > _KERNEL_MAX_OBS
            or spec.head_dim > _KERNEL_MAX_HEAD
        ):
            raise ValueError(f"spec exceeds the kernel's limits: {spec}")
        if spec.groups != nets[0][0].groups:
            raise ValueError("both networks must read the same token groups")
        if x.shape[1] != spec.obs_dim:
            raise ValueError(f"x has {x.shape[1]} columns, spec wants {spec.obs_dim}")
        shapes = leaf_shapes(spec)
        if len(leaves) != len(shapes):
            raise ValueError(f"{len(leaves)} leaves, spec wants {len(shapes)}")
        for i, (leaf, shape) in enumerate(zip(leaves, shapes)):
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


def _launch(x: torch.Tensor, nets) -> Tuple[torch.Tensor, ...]:
    """One kernel launch computing every network of `nets` over `x`."""
    _check_kernel_args(x, nets)
    spec0 = nets[0][0]
    s = x.shape[0]
    outs = [
        torch.empty((s, spec.head_dim), device=x.device, dtype=torch.float32)
        for spec, _ in nets
    ]
    leaf_ptrs = [leaf.data_ptr() for _, leaves in nets for leaf in leaves]
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.mupe_encoder_forward(
            x.data_ptr(), s, spec0.obs_dim, len(spec0.groups),
            build.int_array([k for k, _ in spec0.groups]),
            build.int_array([d for _, d in spec0.groups]),
            len(nets), build.ptr_array(leaf_ptrs), spec0.n_leaves,
            build.ptr_array([o.data_ptr() for o in outs]),
            build.int_array([spec.head_dim for spec, _ in nets]),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(err, "mupe_encoder_forward")
    return tuple(outs)


def _forward(nets, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    if x.device.type == "cpu":
        return tuple(reference_apply(spec, leaves, x) for spec, leaves in nets)
    outs = _launch(x, nets)
    (encoder_forward if len(nets) == 1 else encoder_pair_forward).launches += 1
    return outs


def n_params(spec: EncoderSpec) -> int:
    return sum(math.prod(s) for s in leaf_shapes(spec))


def split_flat(spec: EncoderSpec, flat: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """A flat [n_params] vector → views shaped as the canonical leaves."""
    shapes = leaf_shapes(spec)
    parts = torch.split(flat, [math.prod(s) for s in shapes])
    return tuple(p.view(s) for p, s in zip(parts, shapes))


def _launch_bwd(x: torch.Tensor, nets, douts) -> Tuple[torch.Tensor, ...]:
    """One backward launch (+ its fixed-order reduction) for every network of
    `nets`; returns one flat gradient vector per network."""
    _check_kernel_args(x, nets)
    s = x.shape[0]
    for (spec, _), d in zip(nets, douts):
        if (d.device != x.device or d.dtype != torch.float32 or not d.is_contiguous()
                or tuple(d.shape) != (s, spec.head_dim)):
            raise ValueError(
                f"dout must be contiguous float32 [{s}, {spec.head_dim}] on {x.device}, "
                f"got {d.dtype} {tuple(d.shape)} on {d.device}")
    spec0 = nets[0][0]
    sizes = [n_params(spec) for spec, _ in nets]
    # the transposes of wq, wk, wv, wo, w1, w2, for the kernel's `_mm_nt` products
    base = 2 * len(spec0.groups)
    wts = [leaves[base + i].t().contiguous() for _, leaves in nets for i in (2, 4, 6, 8, 12, 14)]
    grads = [torch.empty(p, device=x.device, dtype=torch.float32) for p in sizes]
    lib = build.library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        build.check(lib.mupe_encoder_backward_blocks(
            len(spec0.groups), spec0.n_tokens, spec0.obs_dim, len(nets), s,
            ctypes.byref(blocks)), "mupe_encoder_backward_blocks")
        ws = torch.empty(blocks.value * sum(sizes), device=x.device, dtype=torch.float32)
        err = lib.mupe_encoder_backward(
            x.data_ptr(), s, spec0.obs_dim, len(spec0.groups),
            build.int_array([k for k, _ in spec0.groups]),
            build.int_array([d for _, d in spec0.groups]),
            len(nets),
            build.ptr_array([leaf.data_ptr() for _, leaves in nets for leaf in leaves]),
            spec0.n_leaves,
            build.ptr_array([d.data_ptr() for d in douts]),
            build.int_array([spec.head_dim for spec, _ in nets]),
            build.ptr_array([w.data_ptr() for w in wts]),
            build.ptr_array([g.data_ptr() for g in grads]),
            build.int_array(sizes), ws.data_ptr(), blocks.value,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(err, "mupe_encoder_backward")
    return tuple(grads)


def encoder_backward(nets, x: torch.Tensor, douts) -> Tuple[Tuple[torch.Tensor, ...], ...]:
    """Parameter gradients of sum_n (out_n · dout_n), summed over the rows,
    for one network or two (`nets` = [(spec, leaves), ...], `douts` one
    [S, head_dim] cotangent each).  Returns per network the gradients in
    the canonical leaf order, views of one flat vector.  On CPU tensors
    `reference_backward`; on CUDA tensors one launch of the kernel in
    `csrc/fused_encoder_bwd.cu` for all the networks."""
    if x.device.type == "cpu":
        return tuple(reference_backward(spec, leaves, x, d)
                     for (spec, leaves), d in zip(nets, douts))
    flats = _launch_bwd(x, nets, [d.contiguous() for d in douts])
    encoder_backward.launches += 1
    return tuple(split_flat(spec, g) for (spec, _), g in zip(nets, flats))


encoder_backward.launches = 0


def _nets(specs, leaves):
    """[(spec, that network's leaves), ...] from the concatenated leaves."""
    nets, off = [], 0
    for spec in specs:
        nets.append((spec, leaves[off : off + spec.n_leaves]))
        off += spec.n_leaves
    return nets


class _EncoderFn(torch.autograd.Function):
    """Forward of one or two networks; the backward recomputes the forward
    from x and the leaves (it saves no activations, as the TPU kernel does)
    and returns no gradient for x (observations are data)."""

    @staticmethod
    def forward(ctx, specs, x, *leaves):
        ctx.specs = specs
        ctx.save_for_backward(x, *leaves)
        return _forward(_nets(specs, leaves), x)

    @staticmethod
    def backward(ctx, *douts):
        x, *leaves = ctx.saved_tensors
        grads = encoder_backward(_nets(ctx.specs, leaves), x, douts)
        return (None, None) + tuple(g for net in grads for g in net)


def encoder_forward(
    spec: EncoderSpec, leaves: Sequence[torch.Tensor], x: torch.Tensor
) -> torch.Tensor:
    """[S, obs_dim] → [S, head_dim] for one network; differentiable in the
    leaves."""
    (out,) = _EncoderFn.apply((spec,), x, *leaves)
    return out


encoder_forward.launches = 0


def encoder_pair_forward(
    spec_a: EncoderSpec,
    spec_b: EncoderSpec,
    leaves_a: Sequence[torch.Tensor],
    leaves_b: Sequence[torch.Tensor],
    x: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two networks over the same rows (actor mean, critic value), one
    kernel launch in each direction; differentiable in both leaf sets."""
    return _EncoderFn.apply((spec_a, spec_b), x, *leaves_a, *leaves_b)


encoder_pair_forward.launches = 0


# ---------------------------------------------------------------- in-kernel PPO loss
@dataclasses.dataclass(frozen=True)
class PPOLossCfg:
    """The PPO loss's constants (`PPOLossCfg` of the JAX package)."""

    clip_param: float
    huber_delta: float
    action_dim: int
    n_rows: int  # S: the means' normaliser


_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)

# column layout of the per-row stats [S, 9 + A]
_SUM_MIN12 = 0   # min(surr1, surr2)
_SUM_RATIO = 1   # ratio
_SUM_RATIO2 = 2  # ratio²
_SUM_H1 = 3      # huber(v − R)
_SUM_H2 = 4      # huber(clip_v − R)
_SUM_SQERR = 5   # (v − R)²
_SUM_RET = 6     # R
_SUM_RET2 = 7    # R²
_SUM_LOGR = 8    # clamped log-ratio (the k3 approx-KL estimator)
_SUM_DLS = 9     # columns 9 .. 9+A: dlogp·(z²−1) per action dimension
_N_STATS = 9


def reference_loss_math(loss: PPOLossCfg, mean, vout, act, logp_old, adv, v_old, ret, log_std):
    """`_loss_math` (fused_encoder.py:605-681) in plain PyTorch, f32, term for
    term: mean [S, A], vout / logp_old / adv / v_old / ret [S, 1], log_std
    [A] → (dmu [S, A], dv1 [S, 1], dv2 [S, 1], stats [S, 9 + A]), the
    gradients of the mean PPO-clip loss (the entropy term aside) and of each
    clipped-Huber value branch, per row.  Every row is a real one (no
    padding), so the row mask is all ones."""
    inv_s = 1.0 / loss.n_rows
    eps, delta = loss.clip_param, loss.huber_delta
    sigma = torch.exp(log_std)
    z = (act - mean) / sigma
    logp = torch.sum(-0.5 * torch.square(z) - log_std - _LOG_SQRT_2PI, dim=-1, keepdim=True)
    log_ratio = logp - logp_old
    ratio = torch.exp(torch.clamp(log_ratio, -20.0, 20.0))
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1.0 - eps, 1.0 + eps) * adv
    in_clip = ((ratio > 1.0 - eps) & (ratio < 1.0 + eps)).to(torch.float32)
    g_ratio = adv * torch.where(surr1 <= surr2, torch.ones_like(in_clip), in_clip)
    # zero gradient where the clamp saturates (its cotangent is zero there)
    unsat = ((log_ratio > -20.0) & (log_ratio < 20.0)).to(torch.float32)
    dlogp = -(loss.action_dim * inv_s) * g_ratio * ratio * unsat
    dmu = dlogp * z / sigma

    d1 = vout - ret
    d2 = v_old + torch.clamp(vout - v_old, -eps, eps) - ret

    def hub(d):
        ad = torch.abs(d)
        return torch.where(ad <= delta, 0.5 * d * d, delta * (ad - 0.5 * delta))

    dv1 = inv_s * torch.clamp(d1, -delta, delta)
    dv2 = inv_s * torch.clamp(d2, -delta, delta) * (torch.abs(vout - v_old) <= eps).to(torch.float32)
    stats = torch.cat([
        torch.minimum(surr1, surr2), ratio, torch.square(ratio), hub(d1), hub(d2),
        torch.square(d1), ret, torch.square(ret), torch.clamp(log_ratio, -20.0, 20.0),
        dlogp * (torch.square(z) - 1.0),
    ], dim=-1)
    return dmu, dv1, dv2, stats


def reference_pair_fwd_loss(spec_a, spec_c, loss, la, lc, log_std, x, act, logp_old, adv,
                            v_old, ret, *, bf16: bool = True):
    """The plain version of `_pair_fwd_loss_kernel`: `reference_apply` for
    both networks, then `reference_loss_math` → (dmu, dv1, dv2, stats).
    bf16=False skips every rounding point of the forwards (the control)."""
    mean = reference_apply(spec_a, la, x, bf16=bf16)
    vout = reference_apply(spec_c, lc, x, bf16=bf16)
    return reference_loss_math(loss, mean, vout, act, logp_old, adv, v_old, ret, log_std)


def reference_pair_fwd_loss_agrad(spec_a, spec_c, loss, la, lc, log_std, x, act, logp_old, adv,
                                  v_old, ret, *, bf16: bool = True):
    """The plain version of `_pair_fwd_loss_agrad_kernel`: (dv1, dv2, stats,
    the actor's gradients with dout = dmu in canonical leaf order)."""
    dmu, dv1, dv2, stats = reference_pair_fwd_loss(
        spec_a, spec_c, loss, la, lc, log_std, x, act, logp_old, adv, v_old, ret, bf16=bf16)
    return dv1, dv2, stats, reference_backward(spec_a, la, x, dmu, bf16=bf16)


def _loss_rows(loss: PPOLossCfg, x, act, logp_old, adv, v_old, ret, log_std):
    """The row inputs as the kernels take them (contiguous f32 on x's
    device: act [S, A], the others [S, 1], log_std [A]); raises otherwise."""
    s, a = x.shape[0], loss.action_dim
    rows = []
    for name, t, shape in (("act", act, (s, a)), ("logp_old", logp_old, (s, 1)),
                           ("adv", adv, (s, 1)), ("v_old", v_old, (s, 1)),
                           ("ret", ret, (s, 1)), ("log_std", log_std, (a,))):
        if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        rows.append(t.contiguous())
    if loss.n_rows != s:
        raise ValueError(f"loss.n_rows {loss.n_rows} != S {s}")
    return rows


def _loss_consts(loss: PPOLossCfg):
    """The loss's f32 constants, in the order the kernels read them."""
    eps, delta, inv_s = loss.clip_param, loss.huber_delta, 1.0 / loss.n_rows
    return build.float_array([eps, 1.0 - eps, 1.0 + eps, delta, 0.5 * delta, inv_s,
                              -(loss.action_dim * inv_s), _LOG_SQRT_2PI])


def _check_loss_nets(spec_a, spec_c, loss, x, la, lc):
    _check_kernel_args(x, [(spec_a, la), (spec_c, lc)])
    if spec_a.head_dim != loss.action_dim or spec_c.head_dim != 1:
        raise ValueError(f"actor head {spec_a.head_dim} (want {loss.action_dim}), "
                         f"critic head {spec_c.head_dim} (want 1)")


def pair_forward_loss(spec_a, spec_c, loss, la, lc, log_std, x, act, logp_old, adv, v_old, ret):
    """Actor and critic forward + the PPO loss's per-row gradient math →
    (dmu [S, A], dv1 [S, 1], dv2 [S, 1], stats [S, 9 + A]).  On CPU tensors
    `reference_pair_fwd_loss`; on CUDA tensors one launch of
    `pair_fwd_loss_kernel` (csrc/fused_encoder_loss.cu)."""
    if x.device.type == "cpu":
        return reference_pair_fwd_loss(spec_a, spec_c, loss, la, lc, log_std, x, act, logp_old,
                                       adv, v_old, ret)
    _check_loss_nets(spec_a, spec_c, loss, x, la, lc)
    rows = _loss_rows(loss, x, act, logp_old, adv, v_old, ret, log_std)
    s, a = x.shape[0], loss.action_dim
    outs = [torch.empty(shape, device=x.device, dtype=torch.float32)
            for shape in ((s, a), (s, 1), (s, 1), (s, _N_STATS + a))]
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.mupe_encoder_fwd_loss(
            x.data_ptr(), s, spec_a.obs_dim, len(spec_a.groups),
            build.int_array([k for k, _ in spec_a.groups]),
            build.int_array([d for _, d in spec_a.groups]),
            build.ptr_array([leaf.data_ptr() for leaf in (*la, *lc)]), spec_a.n_leaves, a,
            build.ptr_array([t.data_ptr() for t in rows]), _loss_consts(loss),
            build.ptr_array([o.data_ptr() for o in outs]),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(err, "mupe_encoder_fwd_loss")
    pair_forward_loss.launches += 1
    return tuple(outs)


pair_forward_loss.launches = 0


def pair_forward_loss_agrad(spec_a, spec_c, loss, la, lc, log_std, x, act, logp_old, adv, v_old,
                            ret):
    """`pair_forward_loss` followed by the actor's backward with dout = dmu,
    in one kernel → (dv1, dv2, stats, the actor's gradients in canonical leaf
    order, views of one flat vector).  On CPU tensors
    `reference_pair_fwd_loss_agrad`; on CUDA tensors one launch of
    `pair_fwd_loss_agrad_kernel` (+ its fixed-order reduction)."""
    if x.device.type == "cpu":
        return reference_pair_fwd_loss_agrad(spec_a, spec_c, loss, la, lc, log_std, x, act,
                                             logp_old, adv, v_old, ret)
    _check_loss_nets(spec_a, spec_c, loss, x, la, lc)
    rows = _loss_rows(loss, x, act, logp_old, adv, v_old, ret, log_std)
    s, a = x.shape[0], loss.action_dim
    outs = [torch.empty(shape, device=x.device, dtype=torch.float32)
            for shape in ((s, 1), (s, 1), (s, _N_STATS + a))]
    p = n_params(spec_a)
    base = 2 * len(spec_a.groups)
    wts = [la[base + i].t().contiguous() for i in (2, 4, 6, 8, 12, 14)]
    grads = torch.empty(p, device=x.device, dtype=torch.float32)
    lib = build.library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        build.check(lib.mupe_encoder_fwd_loss_agrad_blocks(
            len(spec_a.groups), spec_a.n_tokens, spec_a.obs_dim, s, ctypes.byref(blocks)),
            "mupe_encoder_fwd_loss_agrad_blocks")
        ws = torch.empty(blocks.value * p, device=x.device, dtype=torch.float32)
        err = lib.mupe_encoder_fwd_loss_agrad(
            x.data_ptr(), s, spec_a.obs_dim, len(spec_a.groups),
            build.int_array([k for k, _ in spec_a.groups]),
            build.int_array([d for _, d in spec_a.groups]),
            build.ptr_array([leaf.data_ptr() for leaf in (*la, *lc)]), spec_a.n_leaves, a,
            build.ptr_array([t.data_ptr() for t in rows]), _loss_consts(loss),
            build.ptr_array([o.data_ptr() for o in outs]),
            build.ptr_array([w.data_ptr() for w in wts]), grads.data_ptr(), p,
            ws.data_ptr(), blocks.value, torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(err, "mupe_encoder_fwd_loss_agrad")
    pair_forward_loss_agrad.launches += 1
    return (*outs, split_flat(spec_a, grads))


pair_forward_loss_agrad.launches = 0


def _value_branch(loss: PPOLossCfg, sums, dv1, dv2):
    """The clipped-Huber loss is the larger of two batch means: the critic's
    cotangent is that branch's (branch 1 on a tie)."""
    h1 = sums[_SUM_H1] / loss.n_rows
    h2 = sums[_SUM_H2] / loss.n_rows
    return torch.where(h1 >= h2, dv1, dv2)


def pair_ppo_grads_fwdloss(spec_a, spec_c, loss, la, lc, log_std, x, act, logp_old, adv, v_old,
                           ret):
    """The PPO gradients in two launches (`fused_pair_ppo_grads_fwdloss`,
    fused_encoder.py:832-898): `pair_forward_loss`, then the value branch
    chosen from the stats' sums, then one pair launch of `encoder_backward`
    for the actor (dout = dmu) and the critic (dout = dv).  Returns (the
    actor's gradients, the policy term of dlog_std [A], the critic's
    gradients, the stats' column sums [9 + A])."""
    dmu, dv1, dv2, stats = pair_forward_loss(spec_a, spec_c, loss, la, lc, log_std, x, act,
                                             logp_old, adv, v_old, ret)
    sums = stats.sum(0)
    dv = _value_branch(loss, sums, dv1, dv2)
    dla, dlc = encoder_backward([(spec_a, la), (spec_c, lc)], x, [dmu, dv])
    return dla, sums[_SUM_DLS : _SUM_DLS + loss.action_dim], dlc, sums


def pair_ppo_grads(spec_a, spec_c, loss, la, lc, log_std, x, act, logp_old, adv, v_old, ret):
    """The PPO gradients in two launches without recomputing the actor
    (`fused_pair_ppo_grads`, fused_encoder.py:901-975): `pair_forward_loss_agrad`,
    then the critic's backward (one-network `encoder_backward`) with the
    chosen branch's dv.  Returns as `pair_ppo_grads_fwdloss`."""
    dv1, dv2, stats, dla = pair_forward_loss_agrad(spec_a, spec_c, loss, la, lc, log_std, x, act,
                                                   logp_old, adv, v_old, ret)
    sums = stats.sum(0)
    dv = _value_branch(loss, sums, dv1, dv2)
    (dlc,) = encoder_backward([(spec_c, lc)], x, [dv])
    return dla, sums[_SUM_DLS : _SUM_DLS + loss.action_dim], dlc, sums
