"""Observation adapters (counterpart of mupe_tpu/transforms/obs.py): the
sliding history window (the reference's History transform,
transforms.py:493-553; the window is explicit state carried by the env),
flattening a dict observation, decoding discrete actions and normalising
depth frames.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch


def history_init(obs: torch.Tensor, steps: int) -> torch.Tensor:
    """A fresh window filled with the current frame → (..., steps, D)."""
    return obs[..., None, :].expand(obs.shape[:-1] + (steps, obs.shape[-1])).contiguous()


def history_push(window: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """Slide the window one step: drop the oldest frame, append `obs`."""
    return torch.cat([window[..., 1:, :], obs[..., None, :]], dim=-2)


def ravel_composite(obs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A dict observation's entity groups, each (..., k, d) flattened to
    (..., k·d) and concatenated in the dict's order (the reference's
    ravel_composite)."""
    return torch.cat([v.reshape(tuple(v.shape[:-2]) + (v.shape[-2] * v.shape[-1],))
                      for v in obs.values()], dim=-1)


def from_discrete_action(action_idx: torch.Tensor, nbins: int, action_dim: int) -> torch.Tensor:
    """One categorical index of the nbins^action_dim lattice, decoded
    row-major (the first dimension most significant), -> [-1, 1]^action_dim
    (the reference's FromDiscreteAction)."""
    coords, idx = [], action_idx
    for _ in range(action_dim):
        coords.append(idx % nbins)
        idx = idx // nbins
    return torch.stack(coords[::-1], dim=-1).float() / (nbins - 1) * 2.0 - 1.0


def from_multidiscrete_action(action_idx: torch.Tensor, nbins: Sequence[int]) -> torch.Tensor:
    """Per-dimension categorical indices -> [-1, 1] (FromMultiDiscreteAction)."""
    n = torch.as_tensor(nbins, dtype=torch.float32, device=action_idx.device)
    return action_idx.float() / (n - 1.0) * 2.0 - 1.0


def depth_image_norm(depth: torch.Tensor, min_range: float, max_range: float) -> torch.Tensor:
    """Depth clipped to [min_range, max_range] and mapped to [0, 1], near
    being 1 (the reference's DepthImageNorm)."""
    x = torch.clamp(depth, min_range, max_range)
    return (max_range - x) / (max_range - min_range)
