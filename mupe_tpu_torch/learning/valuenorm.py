"""The value normaliser of the update (counterpart of `ValueNorm1`,
mupe_tpu/learning/valuenorm.py:14-57): a debiased EMA of the returns' first
two moments.  Methods return new states, as the JAX package's do."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ValueNorm1:
    running_mean: torch.Tensor     # [1]
    running_mean_sq: torch.Tensor  # [1]
    debiasing_term: torch.Tensor   # []
    beta: float = 0.995
    epsilon: float = 1e-5

    @classmethod
    def create(cls, shape=(1,), beta: float = 0.995, device="cpu") -> "ValueNorm1":
        return cls(torch.zeros(shape, device=device), torch.zeros(shape, device=device),
                   torch.zeros((), device=device), beta=beta)

    def _mean_var(self):
        d = torch.clamp(self.debiasing_term, min=self.epsilon)
        mean = self.running_mean / d
        mean_sq = self.running_mean_sq / d
        var = torch.clamp(mean_sq - torch.square(mean), min=1e-2)
        return mean, var

    def update(self, batch: torch.Tensor) -> "ValueNorm1":
        ndim = self.running_mean.dim()
        dims = tuple(range(batch.dim() - ndim))
        batch_mean = torch.mean(batch, dim=dims)
        batch_sq = torch.mean(torch.square(batch), dim=dims)
        w = self.beta
        return dataclasses.replace(
            self,
            running_mean=self.running_mean * w + batch_mean * (1 - w),
            running_mean_sq=self.running_mean_sq * w + batch_sq * (1 - w),
            debiasing_term=self.debiasing_term * w + (1 - w),
        )

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = self._mean_var()
        return (x - mean) / torch.sqrt(var)

    def denormalize(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = self._mean_var()
        return x * torch.sqrt(var) + mean
