"""The TP net's coordinate maps, as the env uses them (frozen copy of
mupe_tpu_torch/learning/tp_net.py's two functions)."""
from __future__ import annotations

import torch


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
