"""MobileNetV3 feature backbones (counterpart of
mupe_tpu/learning/modules/mobilenet.py; reference torchvision backbone with
`track_running_stats=False`).

Howard et al. 2019, tables 1-2, without pretrained weights, in float32:
the stem (3x3 stride 2), the inverted-residual blocks (`bneck_<i>`: 1x1
expansion where the width changes, a depthwise kxk convolution, squeeze-
excite, a 1x1 projection, the residual at stride 1 with equal widths), a
1x1 convolution to 576 (small) or 960 (large) channels and the average
pool.  Every convolution pads TensorFlow's "SAME" way (`networks.same_pads`:
at stride 2 the odd unit goes at the end), as flax's does.

`_BatchStatsNorm` normalises by the current call's batch statistics over
N, H and W with the biased variance and eps 1e-3, and keeps no running
state: the statistics depend on which frames share a call, so the update
evaluates each minibatch in one call, as the JAX package does.  Across
ranks the call's batch is every rank's frames (`dist.all_reduce_sum_grad`).
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch
from torch import nn
from torch.nn import functional as F

from ...parallel import dist
from ...utils import trace
from .networks import Leaf, apply_conv, apply_dense, conv_leaves, dense_leaves, frames_nchw

BN_EPS = 1e-3  # torchvision MobileNetV3's BatchNorm eps


def _hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def _hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * _hard_sigmoid(x)


def _make_divisible(v: float, divisor: int = 8) -> int:
    """torchvision's channel rounding: a multiple of 8, at most 10% down."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _batch_stats_norm(p, path: str, x: torch.Tensor) -> torch.Tensor:
    """JAX `_BatchStatsNorm` on NCHW `x`: (x - mean) / sqrt(var + 1e-3) over
    N, H, W (biased variance), then the learned scale and bias.  Across
    ranks the batch is every rank's frames, as the JAX partitioner holds it
    globally: the mean from the summed sums and counts, then the variance
    from a second pass, both differentiated across the ranks; every rank
    calls it, a rank without frames with an empty batch."""
    if dist.world_size() > 1:
        both = dist.all_reduce_sum_grad(torch.cat([
            torch.sum(x, dim=(0, 2, 3)),
            x.new_full((1,), x.numel() // x.shape[1])]))
        count = both[-1].detach()
        mean = (both[:-1] / count)[None, :, None, None]
        var = (dist.all_reduce_sum_grad(torch.sum(torch.square(x - mean), dim=(0, 2, 3)))
               / count)[None, :, None, None]
    else:
        mean = torch.mean(x, dim=(0, 2, 3), keepdim=True)
        var = torch.mean(torch.square(x - mean), dim=(0, 2, 3), keepdim=True)
    y = (x - mean) / torch.sqrt(var + BN_EPS)
    return y * p[f"{path}/scale"][:, None, None] + p[f"{path}/bias"][:, None, None]


def _norm_leaves(path: str, c: int) -> List[Leaf]:
    return [Leaf(f"{path}/scale", (c,), "ones"), Leaf(f"{path}/bias", (c,), "zeros")]


@dataclasses.dataclass(frozen=True)
class _BneckCfg:
    kernel: int
    exp: int
    out: int
    se: bool
    hs: bool      # hard-swish (else ReLU)
    stride: int


_SMALL = (
    _BneckCfg(3, 16, 16, True, False, 2),
    _BneckCfg(3, 72, 24, False, False, 2),
    _BneckCfg(3, 88, 24, False, False, 1),
    _BneckCfg(5, 96, 40, True, True, 2),
    _BneckCfg(5, 240, 40, True, True, 1),
    _BneckCfg(5, 240, 40, True, True, 1),
    _BneckCfg(5, 120, 48, True, True, 1),
    _BneckCfg(5, 144, 48, True, True, 1),
    _BneckCfg(5, 288, 96, True, True, 2),
    _BneckCfg(5, 576, 96, True, True, 1),
    _BneckCfg(5, 576, 96, True, True, 1),
)

_LARGE = (
    _BneckCfg(3, 16, 16, False, False, 1),
    _BneckCfg(3, 64, 24, False, False, 2),
    _BneckCfg(3, 72, 24, False, False, 1),
    _BneckCfg(5, 72, 40, True, False, 2),
    _BneckCfg(5, 120, 40, True, False, 1),
    _BneckCfg(5, 120, 40, True, False, 1),
    _BneckCfg(3, 240, 80, False, True, 2),
    _BneckCfg(3, 200, 80, False, True, 1),
    _BneckCfg(3, 184, 80, False, True, 1),
    _BneckCfg(3, 184, 80, False, True, 1),
    _BneckCfg(3, 480, 112, True, True, 1),
    _BneckCfg(3, 672, 112, True, True, 1),
    _BneckCfg(5, 672, 160, True, True, 2),
    _BneckCfg(5, 960, 160, True, True, 1),
    _BneckCfg(5, 960, 160, True, True, 1),
)


def _block_layers(c: _BneckCfg, inp: int):
    """The flax names of one block's convolutions and norms, in call order:
    (conv path, norm path, kind) with kind "expand", "depthwise" or
    "project"."""
    kinds = (["expand"] if c.exp != inp else []) + ["depthwise", "project"]
    return [(f"Conv_{i}", f"_BatchStatsNorm_{i}", kind) for i, kind in enumerate(kinds)]


def _se_leaves(path: str, channels: int) -> List[Leaf]:
    squeeze = _make_divisible(channels / 4)
    return (dense_leaves(f"{path}/Dense_0", channels, squeeze)
            + dense_leaves(f"{path}/Dense_1", squeeze, channels))


def _squeeze_excite(p, path: str, x: torch.Tensor) -> torch.Tensor:
    """GAP -> Dense(exp/4), ReLU -> Dense(exp) -> hard-sigmoid gate."""
    s = torch.mean(x, dim=(2, 3))
    s = apply_dense(p, f"{path}/Dense_1", F.relu(apply_dense(p, f"{path}/Dense_0", s)))
    return x * _hard_sigmoid(s)[:, :, None, None]


class MobileNetV3(nn.Module):
    """JAX `MobileNetV3` (`variant` "small" or "large"): [..., H, W, C]
    frames, C 1 (repeated to 3) or 3, -> [..., 576 | 960] features.
    Stateless: the leaves come from the owning `LeafNet`, under `path`."""

    def __init__(self, path: str = "MobileNetV3_0", variant: str = "small"):
        super().__init__()
        if variant not in ("small", "large"):
            raise ValueError(f"MobileNetV3 variant {variant!r} is not 'small' or 'large'")
        self.path = path
        self.blocks = _SMALL if variant == "small" else _LARGE
        self.out_dim = 576 if variant == "small" else 960

    def leaf_specs(self, c_in: int = 3) -> List[Leaf]:
        """The leaves for frames of `c_in` channels (1 is repeated to 3)."""
        if c_in not in (1, 3):
            raise ValueError(f"MobileNetV3 takes 1 or 3 channels, got {c_in}")
        n = self.path
        leaves = conv_leaves(f"{n}/Conv_0", 3, 16, 3, bias=False) + _norm_leaves(
            f"{n}/_BatchStatsNorm_0", 16)
        inp = 16
        for i, c in enumerate(self.blocks):
            b = f"{n}/bneck_{i}"
            for conv, norm, kind in _block_layers(c, inp):
                if kind == "expand":
                    leaves += conv_leaves(f"{b}/{conv}", inp, c.exp, 1, bias=False)
                elif kind == "depthwise":
                    leaves += conv_leaves(f"{b}/{conv}", c.exp, c.exp, c.kernel, bias=False,
                                          groups=c.exp)
                else:
                    leaves += conv_leaves(f"{b}/{conv}", c.exp, c.out, 1, bias=False)
                leaves += _norm_leaves(f"{b}/{norm}", c.exp if kind != "project" else c.out)
                if kind == "depthwise" and c.se:
                    leaves += _se_leaves(f"{b}/_SqueezeExcite_0", c.exp)
            inp = c.out
        return (leaves + conv_leaves(f"{n}/Conv_1", inp, self.out_dim, 1, bias=False)
                + _norm_leaves(f"{n}/_BatchStatsNorm_1", self.out_dim))

    def forward(self, p, x: torch.Tensor) -> torch.Tensor:
        with trace.span("vision.backbone"):
            return self._forward(p, x)

    def _forward(self, p, x: torch.Tensor) -> torch.Tensor:
        n = self.path
        h, lead = frames_nchw(x)
        if h.shape[1] == 1:
            h = h.expand(-1, 3, -1, -1)
        h = apply_conv(p, f"{n}/Conv_0", h, stride=2)
        h = _hard_swish(_batch_stats_norm(p, f"{n}/_BatchStatsNorm_0", h))
        for i, c in enumerate(self.blocks):
            b = f"{n}/bneck_{i}"
            act = _hard_swish if c.hs else F.relu
            x_in, inp = h, h.shape[1]
            for conv, norm, kind in _block_layers(c, inp):
                if kind == "depthwise":
                    h = apply_conv(p, f"{b}/{conv}", h, stride=c.stride, groups=c.exp)
                else:
                    h = apply_conv(p, f"{b}/{conv}", h)
                h = _batch_stats_norm(p, f"{b}/{norm}", h)
                if kind != "project":
                    h = act(h)
                if kind == "depthwise" and c.se:
                    h = _squeeze_excite(p, f"{b}/_SqueezeExcite_0", h)
            if c.stride == 1 and inp == c.out:
                h = h + x_in
        h = apply_conv(p, f"{n}/Conv_1", h)
        h = _hard_swish(_batch_stats_norm(p, f"{n}/_BatchStatsNorm_1", h))
        return torch.mean(h, dim=(2, 3)).reshape(lead + (self.out_dim,))
