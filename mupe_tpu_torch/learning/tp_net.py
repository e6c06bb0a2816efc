"""TP-net: the evader-prediction LSTM (counterpart of mupe_tpu/learning/tp_net.py).

`TPNet` holds the canonical leaves of `extract_tp_leaves`
(mupe_tpu/ops/tp_lstm.py:58-77): wi [F, 4H], wh [H, 4H], b [4H], wfc [H, O],
bfc [O], gates in (i, f, g, o) order.  Its forward is `tp_forward`: the
TP-LSTM kernel on the card, its plain version on the CPU; gradients reach
the leaves through the TP-LSTM backward (kernel or plain version).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.tp_lstm import TPLSTMSpec, tp_forward
from .modules.networks import lecun_normal, orthogonal


class TPNet(nn.Module):
    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        hidden_dim: int = 64,
        history_step: int = 10,
        leaves: Optional[Sequence[torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
        device: torch.device | str = "cpu",
    ):
        super().__init__()
        self.spec = TPLSTMSpec(input_dim=input_dim, hidden=hidden_dim,
                               t_steps=history_step, out_dim=output_dim)
        if leaves is None:
            leaves = init_tp_leaves(self.spec, generator)
        names = ("wi", "wh", "b", "wfc", "bfc")
        for name, leaf, shape in zip(names, leaves, self.spec.leaf_shapes()):
            if tuple(leaf.shape) != shape:
                raise ValueError(f"TPNet leaf {name}: shape {tuple(leaf.shape)} != {shape}")
            self.register_parameter(
                name, nn.Parameter(torch.as_tensor(leaf, dtype=torch.float32).to(device).contiguous())
            )

    def leaves(self):
        return (self.wi, self.wh, self.b, self.wfc, self.bfc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., history_step, input_dim) → (..., output_dim) in (−1, 1)."""
        return tp_forward(self.spec, self.leaves(), x)


def init_tp_leaves(spec: TPLSTMSpec, generator: Optional[torch.Generator] = None):
    """The initializers of flax's OptimizedLSTMCell + Dense (lecun-normal
    input kernels, orthogonal recurrent kernels, zero biases)."""
    f, h, o = spec.input_dim, spec.hidden, spec.out_dim
    wi = torch.cat([lecun_normal((f, h), generator) for _ in range(4)], dim=1)
    wh = torch.cat([orthogonal(h, h, generator) for _ in range(4)], dim=1)
    return wi, wh, torch.zeros(4 * h), lecun_normal((h, o), generator), torch.zeros(o)


def denormalize_predictions(pred: torch.Tensor, arena_size: float, max_height: float):
    """tanh outputs → arena coordinates: xy · arena/2, z ∈ [0, max_height]."""
    xy = pred[..., :2] * 0.5 * arena_size
    z = (pred[..., 2:3] + 1.0) / 2.0 * max_height
    return torch.cat([xy, z], dim=-1)


def normalize_groundtruth(pos: torch.Tensor, arena_size: float, max_height: float):
    """Inverse mapping for supervision targets."""
    xy = pos[..., :2] / (0.5 * arena_size)
    z = pos[..., 2:3] / max_height * 2.0 - 1.0
    return torch.cat([xy, z], dim=-1)
