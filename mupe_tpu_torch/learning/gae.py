"""Generalized Advantage Estimation (counterpart of mupe_tpu/learning/gae.py).

The same recursion as `compute_gae` (gae.py:19): gae_t = δ_t + γλ·nd_t·gae_{t+1},
δ_t = r_t + γ·v_{t+1}·nd_t − v_t.  The JAX package runs it as an associative
scan, a TPU device; here it is a reverse loop over the (short) time axis.
"""
from __future__ import annotations

from typing import Tuple

import torch


def compute_gae(
    reward: torch.Tensor,      # [T, N, ...]
    done: torch.Tensor,        # broadcastable to reward
    value: torch.Tensor,       # [T, N, ...]
    next_value: torch.Tensor,  # [N, ...], V(s_T)
    gamma: float = 0.99,
    lmbda: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-major GAE → (advantages, returns = advantages + value)."""
    nd = torch.broadcast_to(1.0 - done.to(reward.dtype), reward.shape)
    v_next = torch.cat([value[1:], next_value[None]], dim=0)
    delta = reward + gamma * v_next * nd - value
    coef = gamma * lmbda * nd
    adv = torch.empty_like(reward)
    gae = torch.zeros_like(reward[0])
    for t in reversed(range(reward.shape[0])):
        gae = delta[t] + coef[t] * gae
        adv[t] = gae
    return adv, adv + value
