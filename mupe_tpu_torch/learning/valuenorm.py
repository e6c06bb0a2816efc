"""The value normalisers (counterparts of mupe_tpu/learning/valuenorm.py):
`ValueNorm1`, the update's debiased EMA of the returns' first two moments,
and `ValueNorm2`, Welford's running moments.  Methods return new states, as
the JAX package's do.  Across ranks (`mupe_tpu_torch/parallel`) a batch's
moments and count are every rank's, so the normaliser stays replicated."""
from __future__ import annotations

import dataclasses
import math

import torch

from ..parallel import dist


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
        count = float(math.prod(batch.shape[: batch.dim() - ndim]))
        local = torch.stack([torch.sum(batch, dim=dims), torch.sum(torch.square(batch), dim=dims),
                             torch.full(self.running_mean.shape, count, device=batch.device)])
        sums, sq, counts = dist.all_reduce_sum(local).unbind()
        batch_mean, batch_sq = sums / counts, sq / counts
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


@dataclasses.dataclass
class ValueNorm2:
    """Welford running-moment normaliser (reference valuenorm.py:106-162)."""

    running_mean: torch.Tensor  # [1]
    running_var: torch.Tensor   # [1]
    count: torch.Tensor         # []
    subtract_mean: bool = True

    @classmethod
    def create(cls, shape=(1,), subtract_mean: bool = True, device="cpu") -> "ValueNorm2":
        return cls(torch.zeros(shape, device=device), torch.ones(shape, device=device),
                   torch.zeros((), device=device), subtract_mean=subtract_mean)

    def update(self, batch: torch.Tensor) -> "ValueNorm2":
        """Merge a batch's mean and (unbiased) variance into the moments
        (over every rank's batch: two passes)."""
        ndim = self.running_mean.dim()
        dims = tuple(range(batch.dim() - ndim))
        count = float(math.prod(batch.shape[: batch.dim() - ndim]))
        sums, counts = dist.all_reduce_sum(torch.stack([
            torch.sum(batch, dim=dims),
            torch.full(self.running_mean.shape, count, device=batch.device)])).unbind()
        batch_mean = sums / counts
        batch_var = dist.global_sum(torch.square(batch - batch_mean), dims) / (counts - 1.0)
        batch_count = counts.reshape(-1)[0]
        delta = batch_mean - self.running_mean
        total = self.count + batch_count
        new_mean = self.running_mean + delta * batch_count / total
        m_a = self.running_var * self.count
        m_b = batch_var * batch_count
        m2 = m_a + m_b + torch.square(delta) * self.count * batch_count / total
        return dataclasses.replace(self, running_mean=new_mean, running_var=m2 / total,
                                   count=total)

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        eps = torch.finfo(torch.float32).eps
        if self.subtract_mean:
            return (x - self.running_mean) / torch.sqrt(self.running_var + eps)
        return x / torch.sqrt(self.running_var + eps)

    def denormalize(self, x: torch.Tensor) -> torch.Tensor:
        if self.subtract_mean:
            return x * torch.sqrt(self.running_var) + self.running_mean
        return x * torch.sqrt(self.running_var)
