"""Encoder + linear head, forward and backward, for one network or an
actor+critic pair.

Counterpart of mupe_tpu/ops/fused_encoder.py.  The network is the
PartialAttentionEncoder with a linear head, over a canonical tuple of
parameter leaves (`leaf_shapes`); its plain PyTorch version is
`reference_apply`, which is `_forward_core` (fused_encoder.py:278-364) with
the same bf16 rounding points.  `encoder_forward` and `encoder_pair_forward`
run it on packed observation rows: on CPU tensors through `reference_apply`,
on CUDA tensors through the hand-written kernel in `csrc/fused_encoder.cu`
(one launch for one or both networks, on the tensor cores).  Both are
differentiable in the
leaves: `encoder_backward` (`reference_backward`, the plain version of
`_backward_core`, or two kernel stages: `csrc/fused_encoder_bwd.cu`, the
forward recomputed and the data gradients per row tile, which stages the
bf16 operands of the weight products, then `csrc/weight_grad.cu`, those
products as a split-K GEMM) recomputes the forward and sums the parameter
gradients over the rows.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import math
from typing import Dict, Sequence, Tuple

import torch

from . import build
from .tolerance import GradTol, KernelTol

_LN_EPS = 1e-6  # flax LayerNorm default
# The limits of every encoder kernel (forward, backward, forward + loss) are
# the widths the policy fixes: embed and feed-forward width 128, 1-4 token
# groups, a head of 1-8 outputs (`kernel_spec_ok`).  Tokens, columns and
# group widths are not limited: specs of at most 16 tokens over 160 columns,
# groups of at most 128 features whose weights stack into the tile's two
# slots of 128 rows (`tile_spec_ok`), run the tile instances, which hold a
# tile's rows and tokens in shared memory; past them the kernels stream the
# tokens (an embed launch writes each token's bf16 embed to a scratch the
# wrapper allocates, and the tile reads it a chunk of 8 tokens at a time).
# Past _NARROW_TOKENS tokens the tile instances' backward keeps LN0's n in
# a per-block scratch in device memory (_N0_SCRATCH bf16 values a block and
# network, after its workspace).
_KERNEL_WIDTH = 128
_KERNEL_MAX_GROUPS = 4
_KERNEL_MAX_HEAD = 8
_TILE_MAX_TOKENS = 16
_TILE_MAX_OBS = 160
_NARROW_TOKENS = 8
_N0_SCRATCH = _TILE_MAX_TOKENS * 8 * _KERNEL_WIDTH
# Kernel vs `reference_apply` (see tolerance.py).  With the plain version in
# f64 given (`tolerance.in_f64`), each limit is at least FLOOR_MULT times the
# f32 plain version's own error against it (its floor).
FLOOR_MULT = 5.0
KERNEL_TOL = KernelTol(max_rel=5e-3, mean_rel=1e-4, floor_mult=FLOOR_MULT)
# Backward kernel vs `reference_backward`, per gradient leaf, for sums over
# the main path's tens of thousands of rows; the key bias gradient (15th leaf
# from the end) is analytically zero (see tolerance.py).  Flip cascades make
# a leaf's error track how far its sum cancels at that draw: over 12 seeds x
# S = 49,152 / 49,153 x both networks on an H100
# (scripts/torch_tolerance_survey.py) the kernel's mean error reached
# 2.52e-3 (the critic's embed bias of the 3-wide group) and the f32
# control's fell to 1.17e-3 (the critic's LN2 bias), so no fixed mean limit
# parts them; against the floor, the kernel reached 2.61x it (the critic's
# second FFN bias) and the control stayed above 9.88x it on every leaf
# (2.09x and 11.3x at 8 tokens with a 50-wide group) but those
# of BWD_CONTROL_BLIND: the key bias (noise) and the head bias (no rounding
# point; the control equals the plain version there), which keep the max
# check.  The mean limit is FLOOR_MULT x the floor, at least 1e-4 (the limit
# itself without the f64 version).
BWD_KERNEL_TOL = GradTol(max_rel=1e-2, mean_rel=1e-4, noise_floor=1e-4, noise_leaves=(-15,),
                         floor_mult=FLOOR_MULT)
BWD_CONTROL_BLIND = (-15, -1)
# The weight-gradient stage (`weight_grads`) vs `reference_weight_grads` on
# the same staged operands, per weight leaf: the same bf16 products, summed in
# f32 in another order (chunks, tensor-core tiles) and nothing else.  On an
# H100 (chip_smoke.py phase 2, S = 1 to 49,153) the largest error was 8.3e-6
# of a leaf's largest value, the largest mean error 4.3e-6.
WEIGHT_GRAD_TOL = GradTol(max_rel=1e-4, mean_rel=1e-5)
# The forward + loss kernels' stats [S, 9 + A] vs `reference_loss_math`'s,
# column by column: KERNEL_TOL's mean limit, and twice its max limit, for the
# columns that carry the log-ratio (ratio, ratio², the clamped log-ratio,
# min(surr1, surr2), the dlog_std columns): a row's log-prob error is the
# actor's output error times |act - mean| / sigma² (up to ~10x at sigma =
# e^-1), and ratio² doubles the ratio's relative error.  Measured on an H100
# at S = 49,152: 5.2e-3 on ratio², mean errors under 1e-5; the agrad
# kernel's tensor-core forward reached 1.231x the max limit in 2 of 30 seeds
# (survey), so its limits too are at least FLOOR_MULT x the floor.
LOSS_STATS_TOL = KernelTol(max_rel=1e-2, mean_rel=1e-4, floor_mult=FLOOR_MULT)
# Below 300 rows the forward + loss kernels' per-row outputs keep their max
# limits and get a mean limit of 2e-3: over a handful of rows the mean error
# is one row's, and the plain loss math (torch.exp, its sums) and the kernels'
# (expf, one rounding an operation) part by up to 9.3e-4 of a column's mean
# (the clamped log-ratio and dlog_std columns; the largest errors stayed under
# a quarter of the max limits), past the 1e-4 limit in 12-16 of 180 cases at
# S = 1 to 17 over 30 seeds on an H100 (scripts/torch_tolerance_survey.py),
# for both loss kernels (one forward, the same bits).  The streamed encoder
# forward is held to the per-row limit below 300 rows too: at 28 tokens one
# row's flip cascade took its mean error past 1e-4 in 1 of 120 draws of S = 1
# to 17 where the floor was 0, and stayed within 0.10 of this limit (survey).
# A missed rounding point is caught at S = 49,152, where the mean limits hold
# in full.
SMALL_S_ROWS = 300


def loss_row_tols(s: int):
    """(per-row outputs' limit, stats columns' limit) for s rows."""
    if s >= SMALL_S_ROWS:
        return KERNEL_TOL, LOSS_STATS_TOL
    return (dataclasses.replace(KERNEL_TOL, mean_rel=2e-3),
            dataclasses.replace(LOSS_STATS_TOL, mean_rel=2e-3))


# The agrad kernel's head-bias gradient vs the column sum over the rows of
# the plain version's dmu: a sum whose terms cancel, so the forward's per-row
# deviation from the plain version (within KERNEL_TOL) sums to up to 9.2e-4
# of it, for the fwdloss kernel's own dmu as much as for the agrad kernel's
# (30 seeds, S = 1 to 49,152, H100, scripts/torch_tolerance_survey.py); a
# dropped row moves it by about 1/sqrt(S) of it (4.5e-3 at S = 49,152).
DMU_SUM_TOL = KernelTol(max_rel=5e-3, mean_rel=2e-3)


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
    """x's bf16 value, in x's dtype (f32; f64 under `tolerance.in_f64`)."""
    return x.to(torch.bfloat16).to(x.dtype)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x


def _gelu_tanh(x):
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def _ln_parts(x, scale, bias):
    """LayerNorm → (out, n, inv) as `_ln_f32` of the JAX package returns them."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
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


# The `_mm_tn` products (`dW = Aᵀ D` over the rows) that the weight-gradient
# stage computes, per network: (leaf index after the per-group pairs, A, D).
# A and D name the staged operands of `reference_backward_operands`; "h0" is
# token 0's rows of "h".  The embeds' products (A = the tokens' x slices,
# D = their rows of "de") come after them, one per group.
WEIGHT_PRODUCTS = ((2, "h0", "dq"), (4, "h", "dk"), (6, "h", "dv"), (8, "att", "dr1"),
                   (12, "y1", "dpre1"), (14, "f", "dr2"))


def weight_leaves(spec: EncoderSpec) -> Tuple[int, ...]:
    """Canonical indices of the leaves whose gradients are `_mm_tn` products
    of staged operands (`reference_weight_grads`): the embeds' weights and
    wq, wk, wv, wo, w1, w2.  Every other leaf's gradient is a column sum or
    the head's, from `reference_backward_operands`."""
    base = 2 * len(spec.groups)
    return tuple(2 * g for g in range(len(spec.groups))) + tuple(
        base + i for i, _, _ in WEIGHT_PRODUCTS)


def reference_backward_operands(
    spec: EncoderSpec,
    leaves: Sequence[torch.Tensor],
    x: torch.Tensor,
    dout: torch.Tensor,
    *,
    bf16: bool = True,
):
    """The first stage of the backward in plain PyTorch: `_forward_core`
    recomputed, then `_backward_core` (fused_encoder.py:377-463) at its
    rounding points without its `_mm_tn` products.  Returns (staged, sums):

    * staged: the operands of every `_mm_tn` product, rounded as that
      product rounds them (bf16 values in f32 tensors): token-major "h"
      (h_all), "dk", "dv", "de" [n_tok, S, E]; "att", "y1", "f", "dq",
      "dr1", "dpre1", "dr2" [S, E]; "xs", per group its tokens' x slices
      [k, S, d];
    * sums: {leaf index: gradient} for every leaf that is not in
      `weight_leaves`: the biases and LayerNorm parameters (column sums in
      f32) and the head's weight and bias.

    bf16=False skips every rounding point (the control)."""
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
    base = 2 * len(spec.groups)
    sums = {}

    sums[base + 18] = mm_tn(res["y2"], dout)
    sums[base + 19] = dout.sum(0)
    dy2 = mm_nt(dout, wh)
    dr2, sums[base + 16], sums[base + 17] = _ln_bwd(dy2, res["n2"], res["inv2"], g2)
    sums[base + 15] = dr2.sum(0)
    dpre1 = mm_nt(dr2, w2) * _dgelu_tanh(res["pre1"])
    sums[base + 13] = dpre1.sum(0)
    dy1 = dr2 + mm_nt(dpre1, w1)
    dr1, sums[base + 10], sums[base + 11] = _ln_bwd(dy1, res["n1"], res["inv1"], g1)
    sums[base + 9] = dr1.sum(0)
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
    sums[base + 3] = dq.sum(0)
    sums[base + 5] = dks.sum((0, 1))
    sums[base + 7] = dvs.sum((0, 1))
    dh_all = mm_nt(dks, wk) + mm_nt(dvs, wv)
    dh0 = dh_all[0] + dr1 + mm_nt(dq, wq)
    dh_all = torch.cat([dh0[None], dh_all[1:]])
    de_all, dg0, db0 = _ln_bwd(dh_all, res["n0_all"], res["inv0_all"], g0)
    sums[base + 0], sums[base + 1] = dg0.sum(0), db0.sum(0)
    xs, t = [], 0
    for g, ((k, _), (_, bg)) in enumerate(zip(spec.groups, gw)):
        dbg = torch.zeros_like(bg)
        for _ in range(k):
            dbg = dbg + de_all[t].sum(0)
            t += 1
        sums[2 * g + 1] = dbg
        xs.append(rnd(torch.stack(res["xs"][t - k : t])))
    staged = dict(h=rnd(res["h_all"]), dk=dks, dv=dvs, de=rnd(de_all), att=rnd(res["att"]),
                  y1=rnd(res["y1"]), f=rnd(res["f"]), dq=rnd(dq), dr1=rnd(dr1),
                  dpre1=rnd(dpre1), dr2=rnd(dr2), xs=tuple(xs))
    return staged, sums


def _f32_or_wider(t: torch.Tensor) -> torch.Tensor:
    """A staged operand's values in f32 (f64 ones stay f64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def reference_weight_grads(spec: EncoderSpec, staged) -> Dict[int, torch.Tensor]:
    """The second stage of the backward in plain PyTorch: every `_mm_tn`
    product of `_backward_core` from the staged operands (f32 products and
    sums of their values) → {leaf index: gradient} over `weight_leaves`.
    Takes `reference_backward_operands`' staging or the kernel's (bf16, rows
    past S zero in D, the x slices' columns zero-padded)."""
    base = 2 * len(spec.groups)
    out = {}
    for i, a_key, d_key in WEIGHT_PRODUCTS:
        a = staged["h"][0] if a_key == "h0" else staged[a_key]
        d = staged[d_key]
        out[base + i] = (_f32_or_wider(a).reshape(-1, a.shape[-1]).T
                         @ _f32_or_wider(d).reshape(-1, d.shape[-1]))
    de, t = staged["de"], 0
    for g, ((k, dim), xs) in enumerate(zip(spec.groups, staged["xs"])):
        dwg = torch.zeros((dim, spec.embed_dim), dtype=_f32_or_wider(de).dtype, device=de.device)
        for i in range(k):
            dwg = dwg + _f32_or_wider(xs[i, :, :dim]).T @ _f32_or_wider(de[t])
            t += 1
        out[2 * g] = dwg
    return out


def _canonical(spec: EncoderSpec, sums, wgrads) -> Tuple[torch.Tensor, ...]:
    both = {**sums, **wgrads}
    return tuple(both[i] for i in range(spec.n_leaves))


def reference_backward(
    spec: EncoderSpec,
    leaves: Sequence[torch.Tensor],
    x: torch.Tensor,
    dout: torch.Tensor,
    *,
    bf16: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """Gradients of sum(out · dout) for every leaf, summed over the rows, in
    plain PyTorch: `reference_backward_operands` then
    `reference_weight_grads`, which is `_forward_core` recomputed and
    `_backward_core` (fused_encoder.py:377-463) at its rounding points (both
    operands of every `_mm_tn` / `_mm_nt` in bf16, dout included; dk and dv
    blocks in bf16; n0 in bf16; LayerNorm backward and the column sums in
    f32).  Returns the gradients in the canonical leaf order.  bf16=False
    skips every rounding point: the control that `BWD_KERNEL_TOL` must
    reject."""
    staged, sums = reference_backward_operands(spec, leaves, x, dout, bf16=bf16)
    return _canonical(spec, sums, reference_weight_grads(spec, staged))


def split_k(k_rows: int, blocks: int, step: int) -> Tuple[Tuple[int, int], ...]:
    """The weight-gradient stage's split of a product's K = k_rows staged
    rows over at most `blocks` blocks: chunks of a multiple of `step` rows,
    block c taking [c * chunk, min((c + 1) * chunk, k_rows)), in order.  The
    kernel computes the same bounds from (k_rows, chunk); its partials are
    summed in chunk order."""
    if k_rows <= 0:
        return ()
    chunk = -(-(-(-k_rows // max(blocks, 1))) // step) * step
    return tuple((c, min(c + chunk, k_rows)) for c in range(0, k_rows, chunk))


# ---------------------------------------------------------------- kernel
def _embed_slots(spec: EncoderSpec) -> int:
    """Weight slots the tile's stacked embed weights take (`make_tc_layout`):
    the groups' weights in order, each K padded to 16, a new slot where the
    next would pass 128 rows."""
    slots, rows = 1, 0
    for _, d in spec.groups:
        if rows + _kp(d) > _KERNEL_WIDTH:
            slots, rows = slots + 1, 0
        rows += _kp(d)
    return slots


def kernel_spec_ok(spec: EncoderSpec) -> bool:
    """Whether the encoder kernels (forward, backward, forward + loss) take
    `spec`: embed and feed-forward width 128, 1-4 groups of at least one
    token and one feature, a head of 1-8 outputs.  Any number of tokens,
    columns and features a group: past `tile_spec_ok` the kernels stream the
    tokens."""
    return (spec.embed_dim == _KERNEL_WIDTH and spec.ff_dim == _KERNEL_WIDTH
            and 1 <= len(spec.groups) <= _KERNEL_MAX_GROUPS
            and all(k >= 1 and d >= 1 for k, d in spec.groups)
            and 1 <= spec.head_dim <= _KERNEL_MAX_HEAD)


def tile_spec_ok(spec: EncoderSpec) -> bool:
    """Whether a spec that the kernels take runs their tile instances (the C
    side's `tile_layout`): at most 16 tokens over 160 columns, groups of at
    most 128 features whose weights, each padded to 16 rows, stack into two
    slots of 128.  Past it the streamed instance runs."""
    return (spec.n_tokens <= _TILE_MAX_TOKENS and spec.obs_dim <= _TILE_MAX_OBS
            and all(d <= _KERNEL_WIDTH for _, d in spec.groups) and _embed_slots(spec) <= 2)


def _check_spec(spec: EncoderSpec) -> None:
    if not kernel_spec_ok(spec):
        raise ValueError(
            f"spec exceeds the encoder kernels' limits (embed_dim = ff_dim = {_KERNEL_WIDTH}, "
            f"1-{_KERNEL_MAX_GROUPS} token groups, a head of 1-{_KERNEL_MAX_HEAD} "
            f"outputs): {spec}")


def _n0_scratch_floats(spec: EncoderSpec, blocks: int) -> int:
    """f32 floats of a stage-A kernel's LN0 scratch, blocks per network."""
    return (blocks * _N0_SCRATCH // 2
            if spec.n_tokens > _NARROW_TOKENS and tile_spec_ok(spec) else 0)


def _stream_scratch(fn: str, x: torch.Tensor, *args) -> torch.Tensor:
    """The streaming scratch that a C entry point wants (its `*_scratch`
    helper): bytes on x's device, none for the tile instances."""
    n = ctypes.c_longlong(0)
    build.check(getattr(build.library(), fn)(*args, ctypes.byref(n)), fn)
    return torch.empty(n.value, dtype=torch.uint8, device=x.device)


def _ptr(t: torch.Tensor):
    """A device pointer, or null for an empty tensor."""
    return t.data_ptr() if t.numel() else None


def _check_kernel_args(x: torch.Tensor, nets) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"encoder kernel takes CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            f"x must be contiguous float32 [S, obs_dim], got {x.dtype} "
            f"{tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    for spec, leaves in nets:
        _check_spec(spec)
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
                or (len(shape) == 2 and leaf.data_ptr() % 16)  # the forward's float4 loads
            ):
                raise ValueError(
                    f"leaf {i}: want contiguous float32 {shape} on {x.device}"
                    f"{', 16-byte aligned' if len(shape) == 2 else ''}, got {leaf.dtype} "
                    f"{tuple(leaf.shape)} on {leaf.device}"
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
    s_pad = staged_rows(s)
    with torch.cuda.device(x.device):
        scratch = _stream_scratch("mupe_encoder_forward_scratch", x, *_groups_args(spec0),
                                  len(nets), s_pad)
        err = lib.mupe_encoder_forward(
            x.data_ptr(), s, s_pad, *_groups_args(spec0),
            len(nets), build.ptr_array(leaf_ptrs), spec0.n_leaves,
            build.ptr_array([o.data_ptr() for o in outs]),
            build.int_array([spec.head_dim for spec, _ in nets]), _ptr(scratch),
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


# The backward's staging: rows padded to a multiple of STAGE_ROWS (stage B's
# K step), STAGE_B_ROWS staged rows a stage-B block, about.
STAGE_ROWS = 32
STAGE_B_ROWS = 2048
# the staged operands in the order the C functions take them
_STAGED = ("h", "dk", "dv", "de", "att", "y1", "f", "dq", "dr1", "dpre1", "dr2")


def _kp(d: int) -> int:
    """An embed's K padded to the tensor cores' 16 (with zeros, exactly)."""
    return -(-d // 16) * 16


def staged_rows(s: int) -> int:
    return -(-s // STAGE_ROWS) * STAGE_ROWS


def _staging_shapes(spec: EncoderSpec, s_pad: int):
    nt, e = spec.n_tokens, spec.embed_dim
    return ([(nt, s_pad, e)] * 4 + [(s_pad, e)] * 7
            + [(k, s_pad, _kp(d)) for k, d in spec.groups])


def staging_bytes(spec: EncoderSpec, s: int) -> int:
    """Bytes of one network's staged operands for s rows (bf16)."""
    return 2 * sum(math.prod(sh) for sh in _staging_shapes(spec, staged_rows(s)))


def _alloc_staging(spec: EncoderSpec, s: int, device):
    """One bf16 buffer carved into the staged operands of
    `reference_backward_operands`, each with staged_rows(s) rows, the x
    slices' columns padded to 16; → (the staging dict, its tensors in the C
    functions' order)."""
    shapes = _staging_shapes(spec, staged_rows(s))
    sizes = [math.prod(sh) for sh in shapes]
    flat = torch.empty(sum(sizes), dtype=torch.bfloat16, device=device)
    views = [p.view(sh) for p, sh in zip(torch.split(flat, sizes), shapes)]
    staged = dict(zip(_STAGED, views[:len(_STAGED)]))
    staged["xs"] = tuple(views[len(_STAGED):])
    return staged, views


@functools.lru_cache(maxsize=None)
def _leaf_offsets(spec: EncoderSpec) -> Tuple[int, ...]:
    """Each canonical leaf's offset in a flat vector of the leaves."""
    return tuple(itertools.accumulate((math.prod(sh) for sh in leaf_shapes(spec)), initial=0))


def _bf16_weights(spec: EncoderSpec, leaves):
    """One bf16 copy of the weights the tensor cores read (the bits the
    reference's rounding gives them) → (the copy, a device pointer to each
    of: the embeds' weights stacked, each group's rows padded to a multiple
    of 16 with zero rows; wq, wk, wv, wo, w1, w2, wh)."""
    base = 2 * len(spec.groups)
    parts = []
    for g, (_, d) in enumerate(spec.groups):
        parts += [leaves[2 * g].reshape(-1),
                  leaves[2 * g].new_zeros((_kp(d) - d) * spec.embed_dim)]
    starts = [0]
    for i in (2, 4, 6, 8, 12, 14, 18):
        starts.append(sum(p.numel() for p in parts))
        parts.append(leaves[base + i].reshape(-1))
    copy = torch.cat(parts).to(torch.bfloat16)
    return copy, [copy.data_ptr() + 2 * o for o in starts]


def _colsum_floats(spec: EncoderSpec) -> int:
    """Floats of a stage-A slice (two a block, one for each half of its
    threads): the groups' biases, 12 column-sum leaves, the head's weight
    and bias."""
    return (len(spec.groups) + 12) * spec.embed_dim + (spec.embed_dim + 1) * spec.head_dim


def _groups_args(spec: EncoderSpec):
    return (spec.obs_dim, len(spec.groups), build.int_array([k for k, _ in spec.groups]),
            build.int_array([d for _, d in spec.groups]))


def stage_b_chunk(k_rows: int) -> int:
    """Rows a stage-B block takes of a product's k_rows staged rows: the
    chunk of `split_k` over about k_rows / STAGE_B_ROWS blocks."""
    bounds = split_k(k_rows, max(1, round(k_rows / STAGE_B_ROWS)), STAGE_ROWS)
    return bounds[0][1] - bounds[0][0] if bounds else STAGE_ROWS


def _launch_operands(x: torch.Tensor, nets, douts):
    """Stage A of the backward, one launch (+ its fixed-order reduction) for
    every network of `nets` → (per network its flat gradient vector, every
    leaf but `weight_leaves` filled, and its staging dict)."""
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
    grads = [torch.empty(p, device=x.device, dtype=torch.float32) for p in sizes]
    stagings = [_alloc_staging(spec, s, x.device) for spec, _ in nets]
    wbf = [_bf16_weights(spec, leaves) for spec, leaves in nets]
    lib = build.library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        build.check(lib.mupe_encoder_bwd_blocks(
            *_groups_args(spec0), len(nets), staged_rows(s), ctypes.byref(blocks)),
            "mupe_encoder_bwd_blocks")
        ws = torch.empty(2 * blocks.value * sum(_colsum_floats(spec) for spec, _ in nets)
                         + len(nets) * _n0_scratch_floats(spec0, blocks.value),
                         device=x.device, dtype=torch.float32)
        scratch = _stream_scratch("mupe_encoder_bwd_scratch", x, *_groups_args(spec0),
                                  len(nets), staged_rows(s))
        err = lib.mupe_encoder_bwd_operands(
            x.data_ptr(), s, staged_rows(s), *_groups_args(spec0), len(nets),
            build.ptr_array([leaf.data_ptr() for _, leaves in nets for leaf in leaves]),
            spec0.n_leaves, build.ptr_array([p for _, ptrs in wbf for p in ptrs]),
            build.ptr_array([d.data_ptr() for d in douts]),
            build.int_array([spec.head_dim for spec, _ in nets]),
            build.ptr_array([v.data_ptr() for _, views in stagings for v in views]),
            build.ptr_array([g.data_ptr() for g in grads]),
            build.int_array(sizes), ws.data_ptr(), blocks.value, _ptr(scratch),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(err, "mupe_encoder_bwd_operands")
    return grads, [st for st, _ in stagings]


def _products(spec: EncoderSpec, staged):
    """Stage B's products of one network: (A, D, the gradient's leaf index)."""
    base = 2 * len(spec.groups)
    out = [((staged["h"][0] if a_key == "h0" else staged[a_key]), staged[d_key], base + i)
           for i, a_key, d_key in WEIGHT_PRODUCTS]
    t = 0
    for g, ((k, _), xs) in enumerate(zip(spec.groups, staged["xs"])):
        out.append((xs, staged["de"][t : t + k], 2 * g))
        t += k
    return out


def weight_grads(items) -> None:
    """Stage B of the backward: the `_mm_tn` weight products of every
    network of `items` = [(spec, staged, flat), ...] from its staged
    operands, written into the `weight_leaves` of its flat gradient vector.
    On CPU tensors `reference_weight_grads`; on CUDA tensors one launch of
    the split-K kernel in `csrc/weight_grad.cu` (+ its fixed-order sum of the
    partial products) for all of them.  The staged tensors must be
    contiguous bf16 on the vector's device."""
    if items[0][2].device.type == "cpu":
        for spec, staged, flat in items:
            views = split_flat(spec, flat)
            for i, g in reference_weight_grads(spec, staged).items():
                views[i].copy_(g)
        return
    prods = []
    for spec, staged, flat in items:
        if (flat.dtype != torch.float32 or not flat.is_contiguous()
                or flat.numel() != n_params(spec)):
            raise ValueError(f"the gradient vector must be contiguous float32 "
                             f"[{n_params(spec)}], got {flat.dtype} {tuple(flat.shape)}")
        shapes, offsets = leaf_shapes(spec), _leaf_offsets(spec)
        for a, d, leaf in _products(spec, staged):
            for name, t in (("A", a), ("D", d)):
                if (t.device != flat.device or t.dtype != torch.bfloat16
                        or not t.is_contiguous()):
                    raise ValueError(f"staged {name} must be contiguous bfloat16 on "
                                     f"{flat.device}, got {t.dtype} on {t.device} "
                                     f"contiguous={t.is_contiguous()}")
            k_rows = a.numel() // a.shape[-1]
            m = shapes[leaf][0]
            if (d.numel() != k_rows * spec.embed_dim or k_rows % STAGE_ROWS
                    or a.shape[-1] % 16 or a.shape[-1] < m):
                raise ValueError(f"staged operands of shapes {tuple(a.shape)}, "
                                 f"{tuple(d.shape)} do not match {shapes[leaf]}")
            for c in range(0, a.shape[-1], _KERNEL_WIDTH):  # A's columns, 128 a product
                prods.append(WeightProduct(
                    a.data_ptr() + 2 * c, d.data_ptr(), min(_KERNEL_WIDTH, a.shape[-1] - c),
                    min(_KERNEL_WIDTH, m - c), spec.embed_dim, spec.embed_dim, spec.embed_dim,
                    k_rows, flat.data_ptr() + 4 * (offsets[leaf] + c * spec.embed_dim),
                    a.shape[-1]))
    launch_weight_products(prods, items[0][2].device, stage_b_chunk)
    weight_grads.launches += 1


weight_grads.launches = 0


@dataclasses.dataclass(frozen=True)
class WeightProduct:
    """One product of the weight-gradient kernel: out[:m, :min(n, ldo)] (row
    stride ldo) = A[:, :m]ᵀ D[:, :n] over k_rows staged rows; A bf16 [k_rows,
    sa] of which the first lda (at most 128) columns are read (sa = lda
    unless given), D bf16 [k_rows, ldd] (n at most 128); device pointers."""
    a: int
    d: int
    lda: int
    m: int
    ldd: int
    n: int
    ldo: int
    k_rows: int
    out: int
    sa: int = 0

    @property
    def a_stride(self) -> int:
        return self.sa or self.lda


# products a launch of the weight-gradient kernel takes (WG_MAX_PROD)
_WG_MAX_PROD = 32


def launch_weight_products(prods, dev, chunk_of) -> None:
    """Launches of the split-K kernel of `csrc/weight_grad.cu` (+ its
    fixed-order sum of the partial products), one for every _WG_MAX_PROD
    products of `prods`, K split into chunks of chunk_of(k_rows) rows."""
    for i in range(0, len(prods), _WG_MAX_PROD):
        _launch_weight_batch(prods[i : i + _WG_MAX_PROD], dev, chunk_of)


def _launch_weight_batch(prods, dev, chunk_of) -> None:
    chunks = [chunk_of(p.k_rows) for p in prods]
    ws = torch.empty(sum(-(-p.k_rows // c) * p.m * _KERNEL_WIDTH for p, c in zip(prods, chunks)),
                     device=dev, dtype=torch.float32)
    field = lambda name: [getattr(p, name) for p in prods]  # noqa: E731
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.mupe_weight_grads(
            len(prods), build.ptr_array(field("a")), build.ptr_array(field("d")),
            build.int_array(field("lda")), build.int_array(field("a_stride")),
            build.int_array(field("m")), build.int_array(field("ldd")),
            build.int_array(field("n")), build.int_array(field("ldo")),
            build.int_array(field("k_rows")), build.int_array(chunks),
            build.ptr_array(field("out")), ws.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(err, "mupe_weight_grads")


def encoder_backward(nets, x: torch.Tensor, douts) -> Tuple[Tuple[torch.Tensor, ...], ...]:
    """Parameter gradients of sum_n (out_n · dout_n), summed over the rows,
    for one network or two (`nets` = [(spec, leaves), ...], `douts` one
    [S, head_dim] cotangent each).  Returns per network the gradients in
    the canonical leaf order, views of one flat vector.  On CPU tensors
    `reference_backward`; on CUDA tensors two stages, each one launch for
    all the networks: the tile kernel of `csrc/fused_encoder_bwd.cu`
    (counted here), then `weight_grads`."""
    if x.device.type == "cpu":
        return tuple(reference_backward(spec, leaves, x, d)
                     for (spec, leaves), d in zip(nets, douts))
    flats, stagings = _launch_operands(x, nets, [d.contiguous() for d in douts])
    encoder_backward.launches += 1
    weight_grads([(spec, st, g) for (spec, _), st, g in zip(nets, stagings, flats)])
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


def reference_agrad_operands(spec_a, spec_c, loss, la, lc, log_std, x, act, logp_old, adv,
                             v_old, ret, *, bf16: bool = True):
    """The first stage of `_pair_fwd_loss_agrad_kernel` in plain PyTorch:
    `reference_pair_fwd_loss`, then the actor's `reference_backward_operands`
    with dout = dmu → (dv1, dv2, stats, the actor's staged operands, its
    column sums)."""
    dmu, dv1, dv2, stats = reference_pair_fwd_loss(
        spec_a, spec_c, loss, la, lc, log_std, x, act, logp_old, adv, v_old, ret, bf16=bf16)
    return (dv1, dv2, stats,
            *reference_backward_operands(spec_a, la, x, dmu, bf16=bf16))


def reference_pair_fwd_loss_agrad(spec_a, spec_c, loss, la, lc, log_std, x, act, logp_old, adv,
                                  v_old, ret, *, bf16: bool = True):
    """The plain version of `_pair_fwd_loss_agrad_kernel`: (dv1, dv2, stats,
    the actor's gradients with dout = dmu in canonical leaf order), as
    `reference_agrad_operands` then `reference_weight_grads`."""
    dv1, dv2, stats, staged, sums = reference_agrad_operands(
        spec_a, spec_c, loss, la, lc, log_std, x, act, logp_old, adv, v_old, ret, bf16=bf16)
    return dv1, dv2, stats, _canonical(spec_a, sums, reference_weight_grads(spec_a, staged))


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
    `pair_fwd_loss_kernel` (csrc/fused_encoder_loss.cu; the streamed specs
    after their embed launch)."""
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
        scratch = _stream_scratch("mupe_encoder_fwd_loss_scratch", x, *_groups_args(spec_a),
                                  staged_rows(s), 0)
        err = lib.mupe_encoder_fwd_loss(
            x.data_ptr(), s, staged_rows(s), *_groups_args(spec_a),
            build.ptr_array([leaf.data_ptr() for leaf in (*la, *lc)]), spec_a.n_leaves, a,
            build.ptr_array([t.data_ptr() for t in rows]), _loss_consts(loss),
            build.ptr_array([o.data_ptr() for o in outs]), _ptr(scratch),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(err, "mupe_encoder_fwd_loss")
    pair_forward_loss.launches += 1
    return tuple(outs)


pair_forward_loss.launches = 0


def pair_forward_loss_agrad(spec_a, spec_c, loss, la, lc, log_std, x, act, logp_old, adv, v_old,
                            ret):
    """`pair_forward_loss` followed by the actor's backward with dout = dmu
    → (dv1, dv2, stats, the actor's gradients in canonical leaf order, views
    of one flat vector).  On CPU tensors `reference_pair_fwd_loss_agrad`; on
    CUDA tensors one launch of `pair_fwd_loss_agrad_kernel` (stage A, counted
    here; + its fixed-order reduction), then `weight_grads` for the actor."""
    if x.device.type == "cpu":
        return reference_pair_fwd_loss_agrad(spec_a, spec_c, loss, la, lc, log_std, x, act,
                                             logp_old, adv, v_old, ret)
    outs, grads, staged = _launch_agrad_operands(spec_a, spec_c, loss, la, lc, log_std, x, act,
                                                 logp_old, adv, v_old, ret)
    pair_forward_loss_agrad.launches += 1
    weight_grads([(spec_a, staged, grads)])
    return (*outs, split_flat(spec_a, grads))


def _launch_agrad_operands(spec_a, spec_c, loss, la, lc, log_std, x, act, logp_old, adv, v_old,
                           ret):
    """Stage A of `pair_forward_loss_agrad` → ((dv1, dv2, stats), the actor's
    flat gradient vector with every leaf but `weight_leaves` filled, its
    staging dict)."""
    _check_loss_nets(spec_a, spec_c, loss, x, la, lc)
    rows = _loss_rows(loss, x, act, logp_old, adv, v_old, ret, log_std)
    s, a = x.shape[0], loss.action_dim
    outs = [torch.empty(shape, device=x.device, dtype=torch.float32)
            for shape in ((s, 1), (s, 1), (s, _N_STATS + a))]
    grads = torch.empty(n_params(spec_a), device=x.device, dtype=torch.float32)
    staged, views = _alloc_staging(spec_a, s, x.device)
    wbf = [_bf16_weights(spec_a, la), _bf16_weights(spec_c, lc)]
    lib = build.library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        build.check(lib.mupe_encoder_fwd_loss_agrad_blocks(
            *_groups_args(spec_a), staged_rows(s), ctypes.byref(blocks)),
            "mupe_encoder_fwd_loss_agrad_blocks")
        ws = torch.empty(2 * blocks.value * _colsum_floats(spec_a)
                         + _n0_scratch_floats(spec_a, blocks.value), device=x.device,
                         dtype=torch.float32)
        scratch = _stream_scratch("mupe_encoder_fwd_loss_scratch", x, *_groups_args(spec_a),
                                  staged_rows(s), 1)
        err = lib.mupe_encoder_fwd_loss_agrad(
            x.data_ptr(), s, staged_rows(s), *_groups_args(spec_a),
            build.ptr_array([leaf.data_ptr() for leaf in (*la, *lc)]), spec_a.n_leaves, a,
            build.ptr_array([t.data_ptr() for t in rows]), _loss_consts(loss),
            build.ptr_array([o.data_ptr() for o in outs]),
            build.ptr_array([p for _, ptrs in wbf for p in ptrs]),
            build.ptr_array([v.data_ptr() for v in views]), grads.data_ptr(), n_params(spec_a),
            ws.data_ptr(), blocks.value, _ptr(scratch),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(err, "mupe_encoder_fwd_loss_agrad")
    return outs, grads, staged


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
