"""Operations and bytes of MobileNetV3-Small (ppo_vision's depth backbone)
from its shapes alone, and the H100's float32 peaks.

The layers are the paper's Table 2 as `reference/vision.py` runs them:
"SAME" padding (out = ceil(in / stride)), a 1-channel frame repeated to
the stem's 3 channels, 576 channels before the pool.  Operations are two
per multiply-add of the convolutions and of the squeeze-excite gates'
Dense layers; norms, activations and pools are not counted.  The backward
is two products per forward product (the input's gradient and the
weights'), less the frames' own gradient (the frames take none).

Bytes (float32) count the least traffic a forward needs: each
convolution reads its input and its weights and writes its output; each
norm reads its input twice (statistics, then the normalisation) and
writes once, its activation and gate folded into that write.  The
backward moves twice the forward's bytes (each gradient reads what its
product read and writes what it wrote).
"""
from __future__ import annotations

from typing import Dict, List

from ..reference.vision import LAST, SMALL, STEM, squeeze_width

# H100 SXM, NVIDIA's data sheet: float32 (no tensor cores), memory rate
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def _out(size: int, stride: int) -> int:
    return -(-size // stride)


def layers(h: int, w: int) -> List[Dict[str, int]]:
    """Each convolution of one frame of h x w: its channels in and out,
    groups, kernel, the input's and the output's sizes, and `se`, the
    squeeze width of a gate that follows it (0 for none)."""
    out = []

    def conv(c_in, c_out, k, stride, groups=1, se=0):
        nonlocal h, w
        ho, wo = _out(h, stride), _out(w, stride)
        out.append(dict(c_in=c_in, c_out=c_out, k=k, groups=groups, h=h, w=w, ho=ho, wo=wo,
                        se=se))
        h, w = ho, wo

    conv(3, STEM, 3, 2)
    c = STEM
    for b in SMALL:
        if b.exp != c:
            conv(c, b.exp, 1, 1)
        conv(b.exp, b.exp, b.k, b.stride, groups=b.exp,
             se=squeeze_width(b.exp) if b.se else 0)
        conv(b.exp, b.out, 1, 1)
        c = b.out
    conv(c, LAST, 1, 1)
    return out


def _macs(layer: Dict[str, int]) -> int:
    conv = (layer["ho"] * layer["wo"] * layer["c_out"] * (layer["c_in"] // layer["groups"])
            * layer["k"] ** 2)
    return conv + 2 * layer["c_out"] * layer["se"]


def forward_flops(h: int, w: int, frames: int) -> int:
    return 2 * frames * sum(_macs(l) for l in layers(h, w))


def fwd_bwd_flops(h: int, w: int, frames: int) -> int:
    stem = layers(h, w)[0]
    stem_conv = stem["ho"] * stem["wo"] * stem["c_out"] * stem["c_in"] * stem["k"] ** 2
    return 3 * forward_flops(h, w, frames) - 2 * frames * stem_conv


def _bytes(layer: Dict[str, int], frames: int) -> int:
    """A convolution's input and output, its norm's two reads and one
    write, its (and its gate's) weights once."""
    act_in = layer["c_in"] * layer["h"] * layer["w"]
    act_out = layer["c_out"] * layer["ho"] * layer["wo"]
    weights = (layer["c_out"] * (layer["c_in"] // layer["groups"]) * layer["k"] ** 2
               + 2 * layer["c_out"] * layer["se"])
    return F32 * (frames * (act_in + 4 * act_out) + weights)


def forward_bytes(h: int, w: int, frames: int) -> int:
    return sum(_bytes(l, frames) for l in layers(h, w))


def fwd_bwd_bytes(h: int, w: int, frames: int) -> int:
    return 3 * forward_bytes(h, w, frames)


def fwd_bwd_bound_s(h: int, w: int, frames: int) -> float:
    """The least time of one network's backbone forward and backward."""
    return bound_s(fwd_bwd_flops(h, w, frames), fwd_bwd_bytes(h, w, frames))
