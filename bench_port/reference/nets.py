"""The policy's networks in plain PyTorch, float32, with the configuration's
rounding points: the PartialAttentionEncoder + linear head over entity
groups, the flat LayerNorm + MLP + head, and the TP LSTM.

The arithmetic follows mupe_tpu_torch's plain versions (`_forward_res` of
ops/fused_encoder.py, `FlatHeadNet` of learning/modules/networks.py,
`reference_forward` of ops/tp_lstm.py) as of the benchmark's first
version.  `rnd` says how a value is rounded where the configuration rounds
it: `bf16` (the configuration's `compute_dtype`), `fp8` (the lower
precision of the control) or `exact`.  Rounding is straight through: the
forward value is rounded, the gradient flows in float32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
EMBED = 128
FF = 128
TP_HIDDEN = 64
FP8_MAX = 448.0


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x + (x.to(torch.bfloat16).to(x.dtype) - x).detach()


def fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with a per-tensor scale (its largest value at 448)."""
    scale = torch.clamp(torch.amax(torch.abs(x.detach())), min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


ROUNDING: Dict[str, Callable] = {"exact": exact, "bf16": bf16, "fp8": fp8}


# ------------------------------------------------------------ leaf layouts
def group_order(keys) -> List[str]:
    """The query group first (`state_self`), the other groups sorted."""
    keys = list(keys)
    first = [k for k in keys if k in ("state_self", "state_drones")]
    return first + sorted(k for k in keys if k not in first)


def encoder_table(groups: Sequence[Tuple[int, int]], head: int,
                  names: Sequence[str]) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of each leaf: per group `g` (Wg.g, bg.g), ln0,
    Wq, bq, Wk, bk, Wv, bv, Wo, bo, ln1, W1, b1, W2, b2, ln2, Wh, bh;
    weights [in, out].  Kinds: "w" (a weight), "b" (a bias), "s" (a
    LayerNorm scale)."""
    e, f = EMBED, FF
    out = []
    for g, (_, d) in zip(names, groups):
        out += [(f"Wg.{g}", (d, e), "w"), (f"bg.{g}", (e,), "b")]
    out += [("ln0.s", (e,), "s"), ("ln0.b", (e,), "b")]
    for n in "qkvo":
        out += [(f"W{n}", (e, e), "w"), (f"b{n}", (e,), "b")]
    return out + [("ln1.s", (e,), "s"), ("ln1.b", (e,), "b"), ("W1", (e, f), "w"),
                  ("b1", (f,), "b"), ("W2", (f, e), "w"), ("b2", (e,), "b"), ("ln2.s", (e,), "s"),
                  ("ln2.b", (e,), "b"), ("Wh", (e, head), "w"), ("bh", (head,), "b")]


def flat_table(in_dim: int, hidden: Sequence[int],
               out: int) -> List[Tuple[str, Tuple[int, ...], str]]:
    """LayerNorm(input), then per hidden width `i` (W, b, LN scale, LN
    bias), then the head (W, b)."""
    leaves = [("ln_in.s", (in_dim,), "s"), ("ln_in.b", (in_dim,), "b")]
    d = in_dim
    for i, u in enumerate(hidden):
        leaves += [(f"W{i}", (d, u), "w"), (f"b{i}", (u,), "b"), (f"ln{i}.s", (u,), "s"),
                   (f"ln{i}.b", (u,), "b")]
        d = u
    return leaves + [("Wh", (d, out), "w"), ("bh", (out,), "b")]


def tp_table(in_dim: int, out: int) -> List[Tuple[str, Tuple[int, ...], str]]:
    """wi [F, 4H], wh [H, 4H], b [4H], wfc [H, O], bfc [O]; gates i, f, g, o."""
    h = TP_HIDDEN
    return [("wi", (in_dim, 4 * h), "w"), ("wh", (h, 4 * h), "w"), ("b", (4 * h,), "b"),
            ("wfc", (h, out), "w"), ("bfc", (out,), "b")]


def unnamed(table) -> List[Tuple[Tuple[int, ...], str]]:
    """A table's (shape, kind) pairs: the layout that leaves are made from."""
    return [(shape, kind) for _, shape, kind in table]


def encoder_leaves(groups: Sequence[Tuple[int, int]], head: int) -> List[Tuple[Tuple[int, ...], str]]:
    return unnamed(encoder_table(groups, head, [str(i) for i in range(len(groups))]))


def flat_leaves(in_dim: int, hidden: Sequence[int], out: int) -> List[Tuple[Tuple[int, ...], str]]:
    return unnamed(flat_table(in_dim, hidden, out))


def tp_leaves(in_dim: int, out: int) -> List[Tuple[Tuple[int, ...], str]]:
    return unnamed(tp_table(in_dim, out))


def make_leaves(layout, z: torch.Tensor) -> List[torch.Tensor]:
    """Leaves of `layout` from standard-normal values `z` (consumed in
    order): weights N(0, 1/fan_in), so every layer's output is of order
    one; biases and LayerNorm offsets 0.1 N(0, 1); scales 1 + 0.1 N(0, 1)."""
    out, off = [], 0
    for shape, kind in layout:
        n = math.prod(shape)
        v = z[off:off + n].reshape(shape)
        off += n
        if kind == "w":
            out.append(v / math.sqrt(shape[0]))
        elif kind == "s":
            out.append(1.0 + 0.1 * v)
        else:
            out.append(0.1 * v)
    return out


def layout_size(layout) -> int:
    return sum(math.prod(s) for s, _ in layout)


# ------------------------------------------------------------ networks
def _ln(x, scale, bias):
    m = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - m * m
    return (x - m) * torch.rsqrt(var + LN_EPS) * scale + bias


def _gelu_tanh(x):
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def encoder(groups, leaves, x: torch.Tensor, rnd=bf16) -> torch.Tensor:
    """[S, obs_dim] rows (groups in order, tokens flattened) → [S, head]."""

    def mm(a, b):
        return rnd(a) @ rnd(b)

    it = iter(leaves)
    gw = [(next(it), next(it)) for _ in groups]
    (g0, b0, wq, bq, wk, bk, wv, bv, wo, bo, g1, b1, w1, bf1, w2, bf2,
     g2, b2, wh, bh) = list(it)
    es, off = [], 0
    for (k, d), (wg, bg) in zip(groups, gw):
        for _ in range(k):
            es.append(rnd(mm(x[:, off:off + d], wg) + bg))
            off += d
    e_all = torch.stack(es)                         # [tokens, S, E]
    h_f32 = _ln(e_all, g0, b0)
    h_all = rnd(h_f32)
    h0 = h_f32[0]
    q = mm(h0, wq) + bq
    ks = rnd(mm(h_all, wk) + bk)
    vs = rnd(mm(h_all, wv) + bv)
    s = (q[None] * ks).sum(-1) / math.sqrt(EMBED)   # [tokens, S]
    a = torch.softmax(s, dim=0)
    att = (a[..., None] * vs).sum(0)
    r1 = h0 + (mm(att, wo) + bo)
    y1 = _ln(r1, g1, b1)
    f = _gelu_tanh(mm(y1, w1) + bf1)
    y2 = _ln(y1 + (mm(f, w2) + bf2), g2, b2)
    return mm(y2, wh) + bh


def flat(hidden, leaves, x: torch.Tensor, rnd=bf16) -> torch.Tensor:
    """LayerNorm(x) → (Dense → ELU → LayerNorm) a width, in the compute
    dtype; the head in float32.  [..., D] → [..., out]."""
    x = rnd(_ln(x, leaves[0], leaves[1]))
    i = 2
    for _ in hidden:
        w, b, s, c = leaves[i:i + 4]
        i += 4
        y = rnd(rnd(rnd(x) @ rnd(w)) + rnd(b))
        x = rnd(_ln(rnd(F.elu(y)), s, c))
    return x @ leaves[-2] + leaves[-1]


def tp(leaves, x: torch.Tensor, rnd=bf16) -> torch.Tensor:
    """x [N, T, F] → [N, O] in (-1, 1): rounded products, f32 gates."""
    wi, wh, b, wfc, bfc = leaves
    n, hd = x.shape[0], wh.shape[0]
    h = x.new_zeros((n, hd))
    c = torch.zeros_like(h)
    wi_r, wh_r = rnd(wi), rnd(wh)
    for t in range(x.shape[1]):
        g = (rnd(x[:, t]) @ wi_r + rnd(h) @ wh_r) + b
        gi, gf = torch.sigmoid(g[:, :hd]), torch.sigmoid(g[:, hd:2 * hd])
        gg, go = torch.tanh(g[:, 2 * hd:3 * hd]), torch.sigmoid(g[:, 3 * hd:])
        c = gf * c + gi * gg
        h = go * torch.tanh(c)
    return torch.tanh(rnd(h) @ rnd(wfc) + bfc)


def log_prob(action, mean, log_std) -> torch.Tensor:
    """The diagonal Gaussian's log-density, summed over the last axis."""
    z = (action - mean) * torch.exp(-log_std)
    return torch.sum(-0.5 * z * z - log_std - LOG_SQRT_2PI, dim=-1)


def entropy(log_std, shape) -> torch.Tensor:
    per = log_std + 0.5 * (1.0 + math.log(2.0 * math.pi))
    return torch.sum(per.expand(shape), dim=-1)
