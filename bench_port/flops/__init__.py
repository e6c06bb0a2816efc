"""Operations and bytes of the program's work, from its shapes alone, and
the card's peaks (frozen copies of chip_smoke.py's counts).

Operations are multiply-adds times two of the products; elementwise work
is not counted.  Bytes count each input read once and each output written
once.  A bound is the least time the card could take: the larger of the
operations over the bf16 peak and the bytes over the memory rate.
"""
from __future__ import annotations

from typing import Sequence, Tuple

# H100 SXM, NVIDIA's data sheet, dense: bf16 tensor cores, memory rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
EMBED = 128
FF = 128
TP_HIDDEN = 64
F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def encoder_params(groups: Sequence[Tuple[int, int]], head: int) -> int:
    e, f = EMBED, FF
    return (sum(d * e + e for _, d in groups) + 2 * e + 4 * (e * e + e) + 2 * e
            + e * f + f + f * e + e + 2 * e + e * head + head)


def encoder_flops(groups: Sequence[Tuple[int, int]], head: int, rows: int) -> int:
    """One network's forward: the embeds, q (the first token), k and v
    (every token), the scores and the weighted sum, the out projection,
    the feed-forward block and the head."""
    e, f = EMBED, FF
    t = sum(k for k, _ in groups)
    obs = sum(k * d for k, d in groups)
    per_row = obs * e + e * e + 2 * t * e * e + 2 * t * e + e * e + 2 * e * f + e * head
    return 2 * rows * per_row


def encoder_fwd_bwd_flops(groups, head: int, rows: int) -> int:
    """A forward and the backward's two products per forward product,
    less the observation's gradient (the observation takes none).  It is
    also the backward kernel's own work, which recomputes the forward."""
    obs = sum(k * d for k, d in groups)
    return 3 * encoder_flops(groups, head, rows) - 2 * rows * obs * EMBED


def pair_forward_bound_s(groups, action_dim: int, rows: int) -> float:
    """Actor and critic over the same rows in one launch."""
    obs = sum(k * d for k, d in groups)
    flops = encoder_flops(groups, action_dim, rows) + encoder_flops(groups, 1, rows)
    nbytes = F32 * (rows * obs + encoder_params(groups, action_dim) + encoder_params(groups, 1)
                    + rows * (action_dim + 1))
    return bound_s(flops, nbytes)


def pair_backward_bound_s(groups, action_dim: int, rows: int) -> float:
    """Both networks' backward: it reads the rows, the weights and the
    output gradients and writes the weight gradients."""
    obs = sum(k * d for k, d in groups)
    params = encoder_params(groups, action_dim) + encoder_params(groups, 1)
    flops = encoder_fwd_bwd_flops(groups, action_dim, rows) + encoder_fwd_bwd_flops(groups, 1, rows)
    nbytes = F32 * (rows * obs + 2 * params + rows * (action_dim + 1))
    return bound_s(flops, nbytes)


def tp_flops(in_dim: int, steps: int, out: int, n: int) -> int:
    h = TP_HIDDEN
    return 2 * n * (steps * 4 * h * (in_dim + h) + h * out)


def tp_fwd_bwd_flops(in_dim: int, steps: int, out: int, n: int) -> int:
    """The forward, and per step the gradients of wi and wh and the carried
    state's, with the head's two products."""
    h = TP_HIDDEN
    return tp_flops(in_dim, steps, out, n) + 2 * n * (2 * h * out + steps * 4 * h * (in_dim + 2 * h))


def mlp_flops(in_dim: int, hidden: Sequence[int], out: int, rows: int) -> int:
    """The flat network's forward: its Dense layers and its head."""
    dims = [in_dim, *hidden, out]
    return 2 * rows * sum(a * b for a, b in zip(dims, dims[1:]))


def mlp_fwd_bwd_flops(in_dim: int, hidden: Sequence[int], out: int, rows: int) -> int:
    return 3 * mlp_flops(in_dim, hidden, out, rows) - 2 * rows * in_dim * hidden[0]
