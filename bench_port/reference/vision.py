"""ppo_vision's networks and update in plain PyTorch, float32.

MobileNetV3-Small as Howard et al. 2019 ("Searching for MobileNetV3",
arXiv:1905.02244) give it in Table 2, without the classifier: a 3x3
stride-2 stem to 16 channels, eleven bottlenecks (1x1 expansion where the
expanded width differs from the input's, a kxk depthwise convolution, a
squeeze-excite gate on the blocks that have one, a 1x1 projection without
a nonlinearity, the residual where the stride is 1 and the widths agree),
a 1x1 convolution to 576 channels and the global average pool.  ReLU in
the first three bottlenecks, hard-swish after them and in the stem and the
last convolution; the gate is hard-sigmoid(FC(ReLU(FC(pool(x))))) with
the squeeze width rounded as torchvision's `_make_divisible(exp / 4)`.

Departures from the paper, as the program states them:

- no pretrained weights, no 1x1 convolution to 1024 after the pool and no
  classifier: the 576 pooled features are the backbone's output;
- a 1-channel depth frame is repeated to the stem's 3 channels;
- every convolution pads TensorFlow's "SAME" way: out = ceil(in /
  stride), the odd unit of an uneven pad at the end;
- every norm normalises by the statistics of the current call's batch
  (over frames, rows and columns, biased variance, eps 1e-3) and keeps
  no running statistics, so a frame's features depend on the frames that
  share its call: each minibatch and each step's frames are one call here.

Around the backbone: the mixed-observation encoder (the backbone on the
"depth" frame [..., H, W, 1], MLP (256, 256) on "observation", keys in
sorted order, concatenated, MLP (256,); an MLP layer is Dense, ELU,
LayerNorm with eps 1e-6), then a float32 linear head (the actor's
Gaussian mean, the critic's value).  `VisionLearner` is the reference
learner of `update.py` over these networks: its flat-observation branch
is ppo_vision's non-joint update (the actor's loss with the entropy
bonus and its clipped Adam step, then the critic's).

Matrix products and convolutions run in float32: every network call
turns TF32 off for its duration (`float32()`), whatever the caller set.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .update import Learner

BN_EPS = 1e-3
LN_EPS = 1e-6
STATE_HIDDEN = (256, 256)
OUT_DIM = 256
STEM = 16
LAST = 576


@dataclasses.dataclass(frozen=True)
class Bneck:
    """One row of the paper's Table 2: kernel, expanded width, output
    width, squeeze-excite, hard-swish (else ReLU), stride."""

    k: int
    exp: int
    out: int
    se: bool
    hs: bool
    stride: int


SMALL = (
    Bneck(3, 16, 16, True, False, 2),
    Bneck(3, 72, 24, False, False, 2),
    Bneck(3, 88, 24, False, False, 1),
    Bneck(5, 96, 40, True, True, 2),
    Bneck(5, 240, 40, True, True, 1),
    Bneck(5, 240, 40, True, True, 1),
    Bneck(5, 120, 48, True, True, 1),
    Bneck(5, 144, 48, True, True, 1),
    Bneck(5, 288, 96, True, True, 2),
    Bneck(5, 576, 96, True, True, 1),
    Bneck(5, 576, 96, True, True, 1),
)


def squeeze_width(exp: int) -> int:
    """exp / 4 rounded to a multiple of 8, never more than 10% down."""
    v = exp / 4
    w = max(8, int(v + 4) // 8 * 8)
    return w + 8 if w < 0.9 * v else w


@contextlib.contextmanager
def float32():
    """TF32 off for matrix products and convolutions, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# ------------------------------------------------------------ leaf layouts
# (shape, kind): "c" a convolution's kernel [out, in / groups, k, k], "w" a
# Dense kernel [in, out], "s" a norm's scale, "b" a bias or a norm's offset
def backbone_leaves() -> List[Tuple[Tuple[int, ...], str]]:
    """The backbone's leaves in call order: each convolution's kernel (no
    bias) followed by its norm's scale and offset, a gate's two Dense
    layers after its block's depthwise norm."""
    def conv(c_out, c_in, k):
        return [((c_out, c_in, k, k), "c"), ((c_out,), "s"), ((c_out,), "b")]

    out = conv(STEM, 3, 3)
    c = STEM
    for b in SMALL:
        if b.exp != c:
            out += conv(b.exp, c, 1)
        out += conv(b.exp, 1, b.k)
        if b.se:
            sq = squeeze_width(b.exp)
            out += [((b.exp, sq), "w"), ((sq,), "b"), ((sq, b.exp), "w"), ((b.exp,), "b")]
        out += conv(b.out, b.exp, 1)
        c = b.out
    return out + conv(LAST, c, 1)


def mlp_leaves(d_in: int, units: Sequence[int]) -> List[Tuple[Tuple[int, ...], str]]:
    out = []
    for u in units:
        out += [((d_in, u), "w"), ((u,), "b"), ((u,), "s"), ((u,), "b")]
        d_in = u
    return out


def net_leaves(obs_dim: int, head: int) -> List[Tuple[Tuple[int, ...], str]]:
    """The backbone ("depth" sorts before "observation"), the state MLP,
    the joining MLP and the head."""
    return (backbone_leaves() + mlp_leaves(obs_dim, STATE_HIDDEN)
            + mlp_leaves(LAST + STATE_HIDDEN[-1], (OUT_DIM,)) + [((OUT_DIM, head), "w"),
                                                                 ((head,), "b")])


def make_leaves(layout, z: torch.Tensor) -> List[torch.Tensor]:
    """Leaves from standard-normal values `z` (consumed in order): kernels
    N(0, 1 / fan_in), fan_in a convolution's in / groups x k x k or a Dense
    layer's inputs; biases and offsets 0.1 N(0, 1); scales 1 + 0.1 N(0, 1)."""
    out, off = [], 0
    for shape, kind in layout:
        n = math.prod(shape)
        v = z[off:off + n].reshape(shape)
        off += n
        if kind == "c":
            out.append(v / math.sqrt(math.prod(shape[1:])))
        elif kind == "w":
            out.append(v / math.sqrt(shape[0]))
        elif kind == "s":
            out.append(1.0 + 0.1 * v)
        else:
            out.append(0.1 * v)
    return out


def layout_size(layout) -> int:
    return sum(math.prod(s) for s, _ in layout)


# ------------------------------------------------------------ networks
def hard_sigmoid(x):
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x):
    return x * hard_sigmoid(x)


def _same(x, k: int, stride: int):
    """Pad H and W so a kxk window at `stride` gives ceil(size / stride)."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _conv_norm(it, x, stride: int = 1, groups: int = 1):
    """A "SAME" convolution and the batch-statistics norm after it."""
    w, scale, bias = next(it), next(it), next(it)
    y = F.conv2d(_same(x, w.shape[-1], stride), w, stride=stride, groups=groups)
    mean = y.mean(dim=(0, 2, 3), keepdim=True)
    var = ((y - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    return (y - mean) / torch.sqrt(var + BN_EPS) * scale[:, None, None] + bias[:, None, None]


def backbone(leaves, frames: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 1] depth frames -> [N, 576] pooled features."""
    it = iter(leaves)
    x = frames.permute(0, 3, 1, 2).expand(-1, 3, -1, -1)
    x = hard_swish(_conv_norm(it, x, stride=2))
    for b in SMALL:
        act = hard_swish if b.hs else F.relu
        skip = x
        if b.exp != x.shape[1]:
            x = act(_conv_norm(it, x))
        x = act(_conv_norm(it, x, stride=b.stride, groups=b.exp))
        if b.se:
            w1, b1, w2, b2 = next(it), next(it), next(it), next(it)
            s = F.relu(x.mean(dim=(2, 3)) @ w1 + b1)
            x = x * hard_sigmoid(s @ w2 + b2)[:, :, None, None]
        x = _conv_norm(it, x)
        if b.stride == 1 and skip.shape[1] == x.shape[1]:
            x = x + skip
    x = hard_swish(_conv_norm(it, x))
    return x.mean(dim=(2, 3))


def _layer_norm(x, scale, bias):
    m = x.mean(-1, keepdim=True)
    var = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) / torch.sqrt(var + LN_EPS) * scale + bias


def _mlp(it, x, n: int):
    for _ in range(n):
        w, b, s, c = next(it), next(it), next(it), next(it)
        x = _layer_norm(F.elu(x @ w + b), s, c)
    return x


def net(leaves, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The mixed-observation encoder and the head: {"depth" [..., H, W, 1],
    "observation" [..., D]} -> [..., head]."""
    with float32():
        n_bb = len(backbone_leaves())
        depth = obs["depth"]
        lead = depth.shape[:-3]
        feats = backbone(leaves[:n_bb], depth.reshape((-1,) + tuple(depth.shape[-3:])))
        it = iter(leaves[n_bb:])
        state = _mlp(it, obs["observation"], len(STATE_HIDDEN))
        h = _mlp(it, torch.cat([feats.reshape(lead + (LAST,)), state], dim=-1), 1)
        w, b = next(it), next(it)
        return h @ w + b


@dataclasses.dataclass
class VisionLearner(Learner):
    """The reference learner over the vision networks.  Observations travel
    as rows: each key flattened over its own axes and joined in sorted key
    order ("depth", then "observation"), split back to frames inside the
    networks, so the update's minibatch gathers them as any flat rows.
    `frame` is the depth frame's (H, W, 1)."""

    frame: Tuple[int, ...] = ()

    def obs_rows(self, obs):
        lead = obs["observation"].shape[:-1]
        return torch.cat([obs["depth"].reshape(lead + (-1,)), obs["observation"]], dim=-1)

    def _obs(self, x):
        n = math.prod(self.frame)
        return {"depth": x[..., :n].reshape(x.shape[:-1] + tuple(self.frame)),
                "observation": x[..., n:]}

    def mean(self, x, actor=None):
        return net(self.actor if actor is None else actor, self._obs(x))

    def value(self, x, critic=None):
        return net(self.critic if critic is None else critic, self._obs(x))
