"""Diagonal Gaussian action distribution
(counterpart of `Gaussian` in mupe_tpu/learning/modules/distributions.py)."""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class Gaussian(NamedTuple):
    """Diagonal Gaussian with event dim 1 (torch D.Independent(Normal, 1))."""

    mean: torch.Tensor
    log_std: torch.Tensor

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(self.log_std)

    def sample(
        self, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """mean + std · ε, with ε standard normal from `generator` or given."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                dtype=self.mean.dtype, device=self.mean.device)
        return self.mean + self.std * noise

    @property
    def mode(self) -> torch.Tensor:
        return self.mean

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        z = (value - self.mean) / self.std
        return torch.sum(-0.5 * torch.square(z) - self.log_std - _LOG_SQRT_2PI, dim=-1)

    def entropy(self) -> torch.Tensor:
        per_dim = self.log_std + 0.5 * (1.0 + math.log(2.0 * math.pi))
        return torch.sum(per_dim.expand(self.mean.shape), dim=-1)


class DiagGaussianHead:
    """Linear mean + state-independent log_std (JAX `DiagGaussianHead`,
    distributions.py:50-73): the mean's Dense is xavier-uniform with gain
    0.01 and a zero bias, log_std starts at zero.  The Dense's two leaves
    belong to the owning network's flat vector (under
    `DiagGaussianHead_0/Dense_0`); log_std is held apart, in the policy's
    state (`MAPPOPolicy.init` starts it at zero)."""

    PATH = "DiagGaussianHead_0"

    @staticmethod
    def leaf_specs(in_dim: int, action_dim: int):
        from .networks import dense_leaves

        return dense_leaves(f"{DiagGaussianHead.PATH}/Dense_0", in_dim, action_dim, "actor_head")

    @staticmethod
    def mean(p, feats: torch.Tensor) -> torch.Tensor:
        """The mean from `p` (a `LeafNet.params()` dict), in float32."""
        from .networks import apply_dense

        return apply_dense(p, f"{DiagGaussianHead.PATH}/Dense_0", feats.float())
