"""The sliding observation-history window (counterpart of `history_init` /
`history_push` in mupe_tpu/transforms/obs.py; the reference's History
transform, transforms.py:493-553).  The window is explicit state carried by
the env."""
from __future__ import annotations

import torch


def history_init(obs: torch.Tensor, steps: int) -> torch.Tensor:
    """A fresh window filled with the current frame → (..., steps, D)."""
    return obs[..., None, :].expand(obs.shape[:-1] + (steps, obs.shape[-1])).contiguous()


def history_push(window: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """Slide the window one step: drop the oldest frame, append `obs`."""
    return torch.cat([window[..., 1:, :], obs[..., None, :]], dim=-2)
