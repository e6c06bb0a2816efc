"""Encoders (counterpart of mupe_tpu/learning/modules/networks.py).

The entity encoder of dict observations is the canonical-leaf function of
`mupe_tpu_torch/ops/fused_encoder.py`, not a copy of the flax modules; what
it shares with them is the token order fixed here and the initial weight
distributions.  Flat observations go through `FlatEncoder` (LayerNorm, then
`MLP`) and a float32 head (`FlatHeadNet`): the flax modules' arithmetic, with
Dense layers, ELU and LayerNorm outputs in the compute dtype and the
LayerNorm statistics in float32, as flax's `dtype=` has them.  Their
parameters are one flat float32 vector per network (the layout
`optax.flatten` gives the JAX optimizer) whose views are the leaves.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F


def entity_group_order(keys) -> list:
    """The self/query group first, the rest sorted: for HideAndSeek
    `state_self` 1×35, `cylinders` 3×5, `state_others` 2×3."""
    keys = list(keys)
    self_keys = [k for k in keys if k in ("state_self", "state_drones")]
    rest = sorted(k for k in keys if k not in ("state_self", "state_drones"))
    return self_keys + rest


def lecun_normal(shape: Tuple[int, int], generator: Optional[torch.Generator] = None):
    """flax lecun_normal: normal truncated at ±2σ, variance 1/fan_in."""
    std = math.sqrt(1.0 / shape[0]) / 0.87962566103423978  # truncation correction
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=generator)
    return w * std


def orthogonal(rows: int, cols: int, generator: Optional[torch.Generator] = None):
    w = torch.empty((rows, cols))
    nn.init.orthogonal_(w, generator=generator)
    return w


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype,
               eps: float = 1e-6) -> torch.Tensor:
    """flax `LayerNorm(dtype=dtype)`: mean and E[x^2] - mean^2 in float32, the
    scale folded into rsqrt(var + eps), the result cast to `dtype`."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.clamp(torch.mean(xf * xf, dim=-1, keepdim=True) - mean * mean, min=0.0)
    return ((xf - mean) * (torch.rsqrt(var + eps) * scale) + bias).to(dtype)


def dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """flax `Dense(dtype=dtype)`: input, kernel and bias cast to `dtype`."""
    return torch.matmul(x.to(dtype), kernel.to(dtype)) + bias.to(dtype)


class MLP(nn.Module):
    """Dense -> ELU -> LayerNorm per hidden width (JAX `MLP` with its
    default `layer_norm=True`, the only setting its callers use); its
    leaves are (kernel, bias, ln scale, ln bias) a layer."""

    def __init__(self, in_dim: int, hidden_units: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_dim, self.hidden_units, self.dtype = in_dim, tuple(hidden_units), dtype

    def leaf_shapes(self) -> List[Tuple[int, ...]]:
        shapes, d = [], self.in_dim
        for u in self.hidden_units:
            shapes += [(d, u), (u,), (u,), (u,)]
            d = u
        return shapes

    def forward(self, x: torch.Tensor, leaves: Sequence[torch.Tensor]) -> torch.Tensor:
        for i in range(len(self.hidden_units)):
            w, b, scale, bias = leaves[4 * i: 4 * (i + 1)]
            x = layer_norm(F.elu(dense(x, w, b, self.dtype)), scale, bias, self.dtype)
        return x


class FlatEncoder(nn.Module):
    """LayerNorm(input) -> MLP, the flat-observation encoder (JAX
    `FlatEncoder`); its leaves are the input LayerNorm's then the MLP's."""

    def __init__(self, in_dim: int, hidden_units: Sequence[int] = (256, 256, 256),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.mlp = MLP(in_dim, hidden_units, dtype)

    @property
    def out_dim(self) -> int:
        return self.mlp.hidden_units[-1] if self.mlp.hidden_units else self.mlp.in_dim

    def leaf_shapes(self) -> List[Tuple[int, ...]]:
        return [(self.mlp.in_dim,), (self.mlp.in_dim,)] + self.mlp.leaf_shapes()

    def forward(self, x: torch.Tensor, leaves: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.mlp(layer_norm(x, leaves[0], leaves[1], self.dtype), leaves[2:])


class FlatHeadNet(nn.Module):
    """`FlatEncoder` -> a float32 linear head: the JAX flat Actor's mean (its
    `DiagGaussianHead` Dense) or Critic's value.  `flat` is the one parameter
    vector; `leaves` its views, in `leaf_shapes` order (encoder, then the
    head's kernel and bias)."""

    def __init__(self, in_dim: int, hidden_units: Sequence[int], out_dim: int,
                 dtype: torch.dtype, leaves: Sequence[torch.Tensor]):
        super().__init__()
        self.encoder = FlatEncoder(in_dim, hidden_units, dtype=dtype)
        self.out_dim = out_dim
        shapes = self.leaf_shapes()
        if [tuple(l.shape) for l in leaves] != shapes:
            raise ValueError(f"leaf shapes {[tuple(l.shape) for l in leaves]} != {shapes}")
        self.flat = nn.Parameter(torch.cat(
            [torch.as_tensor(l, dtype=torch.float32).reshape(-1) for l in leaves]))

    def leaf_shapes(self) -> List[Tuple[int, ...]]:
        e = self.encoder.out_dim
        return self.encoder.leaf_shapes() + [(e, self.out_dim), (self.out_dim,)]

    @property
    def leaves(self) -> List[torch.Tensor]:
        sizes = [math.prod(s) for s in self.leaf_shapes()]
        return [p.view(s) for p, s in zip(torch.split(self.flat, sizes), self.leaf_shapes())]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        leaves = self.leaves
        feats = self.encoder(x, leaves[:-2]).float()
        return torch.matmul(feats, leaves[-2]) + leaves[-1]


def init_flat_leaves(in_dim: int, hidden_units: Sequence[int], out_dim: int, head: str,
                     generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
    """The flax initializers of the JAX flat Actor / Critic: lecun-normal
    Dense kernels, zero biases, unit LayerNorm scales; the actor head
    xavier-uniform with gain 0.01, the critic head orthogonal(0.01)."""
    enc = FlatEncoder(in_dim, hidden_units)
    leaves = [torch.ones(in_dim), torch.zeros(in_dim)]
    for w_shape, *rest in zip(*[iter(enc.mlp.leaf_shapes())] * 4):
        leaves += [lecun_normal(w_shape, generator), torch.zeros(rest[0]), torch.ones(rest[1]),
                   torch.zeros(rest[2])]
    e = enc.out_dim
    if head == "actor":
        bound = 0.01 * math.sqrt(6.0 / (e + out_dim))
        wh = (torch.rand((e, out_dim), generator=generator) * 2.0 - 1.0) * bound
    else:
        wh = 0.01 * orthogonal(e, out_dim, generator)
    return leaves + [wh, torch.zeros(out_dim)]
