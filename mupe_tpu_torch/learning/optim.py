"""The update's optimizers, written out as optax has them.

The JAX package steps the actor and the critic with
`optax.flatten(chain(clip_by_global_norm(max_norm), adam(lr)))`, the critic
with `adamw(lr, weight_decay)` in place of `adam(lr)` where `weight_decay >
0`, and the TP net with plain `adam(lr)` (mupe_tpu/learning/mappo.py:346-360).  Here a
parameter group is a list of tensors (the actor's flat encoder vector and its
log_std; the critic's flat vector; the TP net's five leaves): the clip's
global norm runs over the whole group, Adam is elementwise, so flattening
changes nothing but the order of the norm's sum.  The clip is optax's
`select(norm < max_norm, g, g / norm * max_norm)`, not
`torch.nn.utils.clip_grad_norm_`, which adds 1e-6 to the norm.  The functions
return new tensors; `MAPPOPolicy` adds the updates to its parameters.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from ..core.math import const


@dataclasses.dataclass
class AdamState:
    """optax's ScaleByAdamState: step count and the two moments."""

    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: torch.Tensor  # int32 scalar

    @classmethod
    def zeros_like(cls, params: Sequence[torch.Tensor]) -> "AdamState":
        return cls(
            mu=[torch.zeros_like(p, memory_format=torch.contiguous_format) for p in params],
            nu=[torch.zeros_like(p, memory_format=torch.contiguous_format) for p in params],
            count=torch.zeros((), dtype=torch.int32, device=params[0].device),
        )

    def tensors(self) -> List[torch.Tensor]:
        return [*self.mu, *self.nu, self.count]


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares over every tensor."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    g_norm = global_norm(grads)
    keep = g_norm < max_norm
    return [torch.where(keep, g, (g / g_norm) * max_norm) for g in grads]


def adam_updates(
    grads: Sequence[torch.Tensor],
    state: AdamState,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    params: Sequence[torch.Tensor] | None = None,
) -> Tuple[List[torch.Tensor], AdamState]:
    """optax.adam(lr)'s update: (updates to add to the parameters, new
    state), in optax's order of operations.  With `weight_decay > 0` it is
    optax.adamw's: `scale_by_adam`, then `add_decayed_weights` (+ wd · p, on
    every leaf of `params`), then `scale_by_learning_rate`."""
    mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
    nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)]
    count = state.count + 1
    c = count.to(torch.float32)
    # the betas are made on c's device once (`const`): a step copies nothing
    # from the host, so it waits for nothing and can be captured in a graph
    bc1 = 1 - torch.pow(const(b1, c.device), c)
    bc2 = 1 - torch.pow(const(b2, c.device), c)
    direction = [(m / bc1) / (torch.sqrt(v / bc2) + eps) for m, v in zip(mu, nu)]
    if weight_decay > 0.0:
        direction = [d + weight_decay * p for d, p in zip(direction, params)]
    updates = [(-lr) * d for d in direction]
    return updates, AdamState(mu=mu, nu=nu, count=count)
