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

`LeafNet` generalises that layout: each leaf names its flax path (`Leaf`),
which the bridge reads and `init_leaf` initialises as flax does; `HeadNet`
puts a float32 head (the actor's `DiagGaussianHead` Dense or the critic's
value) on a body.  The relation encoders (`RelationEncoder`, and its
partial form) and the PPO family's networks (`learning/ppo/`) are built so.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

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


# ------------------------------------------------------------------ named leaves
class Leaf(NamedTuple):
    """One parameter of a `LeafNet`: its flax path under "params" ("/"
    joined, the bridge's key), its shape in the port's layout ([in, out]
    weights; flax's attention kernels [in, heads, head] / [heads, head, out]
    flattened to [in, out] / [in, out] row-major, so the head split is kept
    as column blocks), how it is initialised, and `perm`, where the port's
    layout is a transpose of flax's (`port = flax.permute(perm)`: a 2-d
    convolution's [kh, kw, in, out] kernel held as torch's [out, in, kh,
    kw])."""

    path: str
    shape: Tuple[int, ...]
    init: str = "lecun"  # lecun | zeros | ones | orthogonal | actor_head | critic_head | normal:σ
    perm: Optional[Tuple[int, ...]] = None


def init_leaf(leaf: Leaf, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's default initialisers: lecun-normal kernels (fan-in over every
    axis but the last of flax's layout, as for a Conv), zero biases, unit
    LayerNorm scales, orthogonal recurrent kernels; the actor head
    xavier-uniform with gain 0.01 (`DiagGaussianHead`), the critic head
    orthogonal(0.01); "normal:σ" σ times a standard normal (`LFF`'s B)."""
    if leaf.perm is not None:
        flax_shape = [0] * len(leaf.shape)
        for i, axis in enumerate(leaf.perm):
            flax_shape[axis] = leaf.shape[i]
        return init_leaf(leaf._replace(shape=tuple(flax_shape), perm=None),
                         generator).permute(leaf.perm).contiguous()
    shape = leaf.shape
    if leaf.init == "zeros":
        return torch.zeros(shape)
    if leaf.init == "ones":
        return torch.ones(shape)
    if leaf.init.startswith("normal:"):
        return float(leaf.init[len("normal:"):]) * torch.randn(shape, generator=generator)
    fan_in, fan_out = math.prod(shape[:-1]), shape[-1]
    if leaf.init == "lecun":
        return lecun_normal((fan_in, fan_out), generator).reshape(shape)
    if leaf.init == "orthogonal":
        return orthogonal(fan_in, fan_out, generator).reshape(shape)
    if leaf.init == "actor_head":
        bound = 0.01 * math.sqrt(6.0 / (fan_in + fan_out))
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound
    if leaf.init == "critic_head":
        return 0.01 * orthogonal(fan_in, fan_out, generator).reshape(shape)
    raise ValueError(f"unknown initialiser {leaf.init!r}")


def dense_leaves(path: str, d_in: int, d_out: int, init: str = "lecun",
                 bias: bool = True) -> List[Leaf]:
    return [Leaf(f"{path}/kernel", (d_in, d_out), init)] + (
        [Leaf(f"{path}/bias", (d_out,), "zeros")] if bias else [])


def ln_leaves(path: str, d: int) -> List[Leaf]:
    return [Leaf(f"{path}/scale", (d,), "ones"), Leaf(f"{path}/bias", (d,), "zeros")]


def mlp_leaves(path: str, d_in: int, units: Sequence[int]) -> List[Leaf]:
    """A flax `MLP` (Dense -> ELU -> LayerNorm a width) under `path`."""
    leaves = []
    for i, u in enumerate(units):
        leaves += dense_leaves(f"{path}/Dense_{i}", d_in, u) + ln_leaves(f"{path}/LayerNorm_{i}", u)
        d_in = u
    return leaves


def apply_dense(p, path: str, x: torch.Tensor, dtype: torch.dtype = torch.float32):
    bias = p.get(f"{path}/bias")
    if bias is None:
        return torch.matmul(x.to(dtype), p[f"{path}/kernel"].to(dtype))
    return dense(x, p[f"{path}/kernel"], bias, dtype)


def apply_ln(p, path: str, x: torch.Tensor, dtype: torch.dtype = torch.float32):
    return layer_norm(x, p[f"{path}/scale"], p[f"{path}/bias"], dtype)


def apply_mlp(p, path: str, x: torch.Tensor, n_layers: int,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    for i in range(n_layers):
        x = apply_ln(p, f"{path}/LayerNorm_{i}", F.elu(apply_dense(p, f"{path}/Dense_{i}", x, dtype)),
                     dtype)
    return x


def leaf_views(specs: Sequence[Leaf], flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Each leaf's view of the flat vector `flat`, keyed by its path."""
    sizes = [math.prod(l.shape) for l in specs]
    return {l.path: v.view(l.shape) for l, v in zip(specs, torch.split(flat, sizes))}


class LeafNet(nn.Module):
    """A network whose parameters are one flat float32 vector (`flat`, the
    layout `optax.flatten` gives the JAX optimizer) whose views are its
    leaves, in `leaf_specs` order; `params()` maps each leaf's flax path to
    its view.  Subclasses set their sizes, then call `_make_flat`."""

    def leaf_specs(self) -> List[Leaf]:
        raise NotImplementedError

    def leaf_shapes(self) -> List[Tuple[int, ...]]:
        return [l.shape for l in self.leaf_specs()]

    def _make_flat(self, leaves=None, generator: Optional[torch.Generator] = None) -> None:
        specs = self.leaf_specs()
        if leaves is None:
            leaves = [init_leaf(l, generator) for l in specs]
        got = [tuple(l.shape) for l in leaves]
        if got != [l.shape for l in specs]:
            raise ValueError(f"{type(self).__name__}: leaf shapes {got} != "
                             f"{[l.shape for l in specs]}")
        self.flat = nn.Parameter(torch.cat(
            [torch.as_tensor(l, dtype=torch.float32).reshape(-1) for l in leaves]))

    @property
    def leaves(self) -> List[torch.Tensor]:
        return list(leaf_views(self.leaf_specs(), self.flat).values())

    def params(self) -> Dict[str, torch.Tensor]:
        return leaf_views(self.leaf_specs(), self.flat)


def _feat(obs, key: str):
    """obs[key] for a dict observation, else the observation itself (the
    PPO family's `obs["observation"] if isinstance(obs, dict) else obs`)."""
    return obs[key] if isinstance(obs, dict) else obs


# ------------------------------------------------------------------ relation encoders
def split_embedding_leaves(path: str, groups: Dict[str, Tuple[int, int]], embed: int):
    leaves = []
    for name in entity_group_order(groups):
        leaves += dense_leaves(f"{path}/embed_{name}", groups[name][1], embed)
    return leaves + ln_leaves(f"{path}/LayerNorm_0", embed)


def apply_split_embedding(p, path: str, obs: Dict[str, torch.Tensor], dtype) -> torch.Tensor:
    """flax `SplitEmbedding`: a Dense per group in canonical order,
    concatenated along the token axis, then LayerNorm."""
    x = torch.cat([apply_dense(p, f"{path}/embed_{name}", obs[name], dtype)
                   for name in entity_group_order(obs.keys())], dim=-2)
    return apply_ln(p, f"{path}/LayerNorm_0", x, dtype)


RELATION_EMBED, RELATION_F_UNITS = 72, (256, 128)


class RelationEncoder(nn.Module):
    """f(sum_ij g(a_i + a_j)) over all entity pairs (JAX `RelationEncoder`,
    networks.py:130-145), or with `partial` f(sum_j g(a_0 + a_j)), j != 0
    (`PartialRelationEncoder`, :148-163); `+` is concatenation.  Dense
    layers, ELU and LayerNorm outputs in `dtype`; the pair sum accumulates
    in float32 and rounds to `dtype`, as `jnp.sum` does.  Stateless: the
    leaves come from the owning `LeafNet`'s `params()`."""

    def __init__(self, partial: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.partial, self.dtype = partial, dtype
        self.name = "PartialRelationEncoder_0" if partial else "RelationEncoder_0"

    def leaf_specs(self, groups: Dict[str, Tuple[int, int]]) -> List[Leaf]:
        n = self.name
        g0 = RELATION_F_UNITS[0]
        return (split_embedding_leaves(f"{n}/SplitEmbedding_0", groups, RELATION_EMBED)
                + mlp_leaves(f"{n}/MLP_0", 2 * RELATION_EMBED, (g0,))
                + ln_leaves(f"{n}/LayerNorm_0", g0)
                + mlp_leaves(f"{n}/MLP_1", g0, RELATION_F_UNITS))

    def forward(self, p, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        n, dt = self.name, self.dtype
        a = apply_split_embedding(p, f"{n}/SplitEmbedding_0", obs, dt)
        k = a.shape[-2]
        if self.partial:
            aj = a[..., 1:, :]
            aij = torch.cat([a[..., :1, :].expand(aj.shape), aj], dim=-1)
            dims = (-2,)
        else:
            ai = a[..., :, None, :].expand(a.shape[:-1] + (k, a.shape[-1]))
            aij = torch.cat([ai, ai.transpose(-2, -3)], dim=-1)
            dims = (-3, -2)
        g = apply_ln(p, f"{n}/LayerNorm_0", apply_mlp(p, f"{n}/MLP_0", aij, 1, dt), dt)
        pooled = torch.sum(g.float(), dim=dims).to(dt)
        return apply_mlp(p, f"{n}/MLP_1", pooled, len(RELATION_F_UNITS), dt)


def head_leaves(role: str, d_in: int, out_dim: int) -> List[Leaf]:
    """The actor's `DiagGaussianHead` Dense or the critic's value Dense."""
    from .distributions import DiagGaussianHead

    if role == "actor":
        return DiagGaussianHead.leaf_specs(d_in, out_dim)
    return dense_leaves("Dense_0", d_in, out_dim, "critic_head")


def apply_head(p, role: str, feats: torch.Tensor) -> torch.Tensor:
    """The head of `role` on `feats`, in float32."""
    from .distributions import DiagGaussianHead

    if role == "actor":
        return DiagGaussianHead.mean(p, feats)
    return apply_dense(p, "Dense_0", feats.float())


class HeadNet(LeafNet):
    """A body (the subclass's `body_specs` / `body`) and a float32 linear
    head on its features: the actor's Gaussian mean
    (`DiagGaussianHead_0/Dense_0`, xavier-uniform with gain 0.01; `role`
    "actor") or the critic's values (`Dense_0`, orthogonal(0.01); "critic").
    Subclasses set their own fields, then call `_setup`."""

    def _setup(self, example, out_dim: int, role: str, leaves=None, generator=None) -> None:
        self.out_dim, self.role = out_dim, role
        self._body_specs, self.feat_dim = self.body_specs(example)
        self._make_flat(leaves, generator)

    def body_specs(self, example) -> Tuple[List[Leaf], int]:
        raise NotImplementedError

    def body(self, p, obs) -> torch.Tensor:
        raise NotImplementedError

    def leaf_specs(self) -> List[Leaf]:
        return self._body_specs + head_leaves(self.role, self.feat_dim, self.out_dim)

    def forward(self, obs) -> torch.Tensor:
        p = self.params()
        return apply_head(p, self.role, self.body(p, obs))


class RelationHeadNet(HeadNet):
    """A relation encoder over dict observations, then the float32 head:
    the JAX Actor / Critic with `attn_encoder="RelationEncoder"` /
    `"PartialRelationEncoder"`."""

    def __init__(self, attn_encoder: str, groups: Dict[str, Tuple[int, int]], out_dim: int,
                 role: str, dtype: torch.dtype, leaves=None, generator=None):
        super().__init__()
        self.encoder = RelationEncoder(attn_encoder == "PartialRelationEncoder", dtype)
        self._setup(dict(groups), out_dim, role, leaves, generator)

    def body_specs(self, groups):
        return self.encoder.leaf_specs(groups), RELATION_F_UNITS[-1]

    def body(self, p, obs):
        return self.encoder(p, obs)


# ------------------------------------------------------------------ Fourier features
class LFF(nn.Module):
    """Learnable Fourier features (JAX `LFF`): B [in, fourier_dim] starts at
    sigma times a standard normal; x -> Dense([sin(2π x B), cos(2π x B), x])
    (x left out without `cat_input`).  Stateless: the leaves come from the
    owning `LeafNet`, under `path`."""

    def __init__(self, path: str = "LFF_0", fourier_dim: int = 256, embed_dim: int = 72,
                 sigma: float = 0.01, cat_input: bool = True):
        super().__init__()
        self.path, self.fourier_dim, self.embed_dim = path, fourier_dim, embed_dim
        self.sigma, self.cat_input = sigma, cat_input

    def leaf_specs(self, d_in: int) -> List[Leaf]:
        width = 2 * self.fourier_dim + (d_in if self.cat_input else 0)
        return ([Leaf(f"{self.path}/B", (d_in, self.fourier_dim), f"normal:{self.sigma}")]
                + dense_leaves(f"{self.path}/Dense_0", width, self.embed_dim))

    def forward(self, p, x: torch.Tensor) -> torch.Tensor:
        proj = torch.matmul(x, p[f"{self.path}/B"]) * (2.0 * math.pi)
        feats = [torch.sin(proj), torch.cos(proj)] + ([x] if self.cat_input else [])
        return apply_dense(p, f"{self.path}/Dense_0", torch.cat(feats, dim=-1))


# ------------------------------------------------------------------ vision
# flax's Conv kernel [kh, kw, in, out] (depthwise: [kh, kw, 1, C]) as torch's
# [out, in, kh, kw]
CONV_PERM = (3, 2, 0, 1)


def conv_leaves(path: str, c_in: int, c_out: int, k: int, bias: bool = True,
                groups: int = 1) -> List[Leaf]:
    """A flax `nn.Conv(c_out, (k, k), feature_group_count=groups)`."""
    return [Leaf(f"{path}/kernel", (c_out, c_in // groups, k, k), "lecun", CONV_PERM)] + (
        [Leaf(f"{path}/bias", (c_out,), "zeros")] if bias else [])


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """TensorFlow's (and flax's default) "SAME" padding of one axis: out =
    ceil(size / stride); the total pad's odd unit goes at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def apply_conv(p, path: str, x: torch.Tensor, stride: int = 1, groups: int = 1) -> torch.Tensor:
    """flax `Conv(padding="SAME")` on NCHW `x`, float32."""
    kernel = p[f"{path}/kernel"]
    k = kernel.shape[-1]
    top, bottom = same_pads(x.shape[-2], k, stride)
    left, right = same_pads(x.shape[-1], k, stride)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, kernel, p.get(f"{path}/bias"), stride=stride, groups=groups)


def frames_nchw(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """[..., H, W, C] frames -> ([N, C, H, W], the leading shape)."""
    lead = tuple(x.shape[:-3])
    return x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2), lead


class ConvVisionEncoder(nn.Module):
    """JAX `ConvVisionEncoder`: three 3x3 stride-2 "SAME" convolutions (16,
    32, 64 channels, ReLU), a global average pool and Dense(128), over
    [..., H, W, C] frames; float32.  Stateless, its leaves under `path`."""

    FEATURES = (16, 32, 64)

    def __init__(self, path: str, out_dim: int = 128):
        super().__init__()
        self.path, self.out_dim = path, out_dim

    def leaf_specs(self, c_in: int) -> List[Leaf]:
        leaves, c = [], c_in
        for i, feat in enumerate(self.FEATURES):
            leaves += conv_leaves(f"{self.path}/Conv_{i}", c, feat, 3)
            c = feat
        return leaves + dense_leaves(f"{self.path}/Dense_0", c, self.out_dim)

    def forward(self, p, x: torch.Tensor) -> torch.Tensor:
        h, lead = frames_nchw(x)
        for i in range(len(self.FEATURES)):
            h = F.relu(apply_conv(p, f"{self.path}/Conv_{i}", h, stride=2))
        h = apply_dense(p, f"{self.path}/Dense_0", torch.mean(h, dim=(-2, -1)))
        return h.reshape(lead + (self.out_dim,))


VISION_ENCODERS = ("conv", "mobilenet_v3_small", "mobilenet_v3_large")


def make_vision_encoder(kind: str, path: str) -> nn.Module:
    """The vision backbone `kind` under `path` (JAX `make_vision_encoder`)."""
    if kind == "conv":
        return ConvVisionEncoder(path)
    if kind in ("mobilenet_v3_small", "mobilenet_v3_large"):
        from .mobilenet import MobileNetV3

        return MobileNetV3(path, variant=kind.rsplit("_", 1)[1])
    raise ValueError(f"unknown vision encoder {kind!r}; have {VISION_ENCODERS}")


class MixedObsEncoder(nn.Module):
    """JAX `MixedObsEncoder`: a vision backbone on each key of
    `vision_keys` (`vision_<key>`), `MLP((256, 256))` on every other key,
    concatenated and projected by `MLP((256,))`; float32.  The keys go in
    sorted order: the JAX package's programs are jitted, and jit hands a
    dict to the module with its keys sorted whatever order the env built it
    in.  Stateless, its leaves under `path`."""

    STATE_HIDDEN, OUT_DIM = (256, 256), 256

    def __init__(self, path: str = "MixedObsEncoder_0", vision_keys: Sequence[str] = ("depth",),
                 vision_encoder: str = "conv"):
        super().__init__()
        self.path, self.vision_keys, self.kind = path, tuple(vision_keys), vision_encoder

    def _branches(self, keys):
        """(key, vision backbone or None, MLP path) in the order flax names them."""
        out, mlps = [], 0
        for key in sorted(keys):
            if key in self.vision_keys:
                out.append((key, make_vision_encoder(self.kind, f"{self.path}/vision_{key}"), None))
            else:
                out.append((key, None, f"{self.path}/MLP_{mlps}"))
                mlps += 1
        return out, f"{self.path}/MLP_{mlps}"

    def leaf_specs(self, example: Dict[str, torch.Tensor]) -> List[Leaf]:
        branches, out_path = self._branches(example)
        leaves, width = [], 0
        for key, enc, mlp in branches:
            if enc is not None:
                leaves += enc.leaf_specs(example[key].shape[-1])
                width += enc.out_dim
            else:
                leaves += mlp_leaves(mlp, example[key].shape[-1], self.STATE_HIDDEN)
                width += self.STATE_HIDDEN[-1]
        return leaves + mlp_leaves(out_path, width, (self.OUT_DIM,))

    def forward(self, p, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        branches, out_path = self._branches(obs)
        feats = [enc(p, obs[key]) if enc is not None
                 else apply_mlp(p, mlp, obs[key], len(self.STATE_HIDDEN))
                 for key, enc, mlp in branches]
        return apply_mlp(p, out_path, torch.cat(feats, dim=-1), 1)


class VisionNet(HeadNet):
    """`MixedObsEncoder` and a head: JAX `VisionActor` / `VisionCritic`
    (ppo_vision's networks over a dict with a "depth" frame)."""

    def __init__(self, example, out_dim: int, role: str, vision_encoder: str = "conv",
                 leaves=None, generator=None):
        super().__init__()
        self.encoder = MixedObsEncoder(vision_encoder=vision_encoder)
        self._setup(example, out_dim, role, leaves, generator)

    def body_specs(self, obs):
        return self.encoder.leaf_specs(obs), MixedObsEncoder.OUT_DIM

    def body(self, p, obs):
        return self.encoder(p, obs)
