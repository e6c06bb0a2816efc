"""Action distributions (counterpart of
mupe_tpu/learning/modules/distributions.py): the diagonal `Gaussian` and its
head, the tanh-squashed Gaussian, the Beta, independent categoricals and
the two-hot scalar distribution.  Draws are injected (`noise`, a unit Beta
`unit`) or come from an explicit `torch.Generator`; the JAX package's
streams cannot be reproduced."""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

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


class TanhGaussian(NamedTuple):
    """Tanh-squashed diagonal Gaussian (JAX `TanhGaussian`, reference
    TanhIndependentNormal): `sample` squashes mean + std · ε, `log_prob`
    inverts the squash with the value clipped 1e-6 inside (-1, 1) and
    subtracts log(1 - tanh² + 1e-6) per dimension."""

    mean: torch.Tensor
    log_std: torch.Tensor

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return torch.tanh(Gaussian(self.mean, self.log_std).sample(generator, noise))

    @property
    def mode(self) -> torch.Tensor:
        return torch.tanh(self.mean)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        eps = 1e-6
        pre = torch.atanh(torch.clamp(value, -1.0 + eps, 1.0 - eps))
        base = Gaussian(self.mean, self.log_std).log_prob(pre)
        return base - torch.sum(torch.log(1.0 - torch.square(torch.tanh(pre)) + eps), dim=-1)


class Beta(NamedTuple):
    """Independent Beta on [low, high] (JAX `Beta`).  torch's Beta sampler
    takes no generator, so `sample` maps a unit Beta(alpha, beta) draw of
    the caller's (`torch.distributions.Beta(alpha, beta).sample()`) affinely
    onto [low, high]."""

    alpha: torch.Tensor
    beta: torch.Tensor
    low: float = 0.0
    high: float = 1.0

    def sample(self, unit: torch.Tensor) -> torch.Tensor:
        return unit * (self.high - self.low) + self.low

    @property
    def mode(self) -> torch.Tensor:
        m = (self.alpha - 1.0) / (self.alpha + self.beta - 2.0)
        return m * (self.high - self.low) + self.low

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        x = torch.clamp((value - self.low) / (self.high - self.low), 1e-6, 1 - 1e-6)
        lp = ((self.alpha - 1.0) * torch.log(x) + (self.beta - 1.0) * torch.log1p(-x)
              - (torch.lgamma(self.alpha) + torch.lgamma(self.beta)
                 - torch.lgamma(self.alpha + self.beta))) - math.log(self.high - self.low)
        return torch.sum(lp, dim=-1)


class MultiCategorical(NamedTuple):
    """Independent categoricals over a tuple of logit groups (..., n_i)
    (JAX `MultiCategorical`); values are [..., groups] indices."""

    logits: Tuple[torch.Tensor, ...]

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return torch.stack([
            torch.multinomial(torch.softmax(l.reshape(-1, l.shape[-1]), dim=-1), 1,
                              generator=generator).reshape(l.shape[:-1])
            for l in self.logits], dim=-1)

    @property
    def mode(self) -> torch.Tensor:
        return torch.stack([torch.argmax(l, dim=-1) for l in self.logits], dim=-1)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return sum(torch.gather(torch.log_softmax(l, dim=-1), -1, value[..., i:i + 1].long())[..., 0]
                   for i, l in enumerate(self.logits))

    def entropy(self) -> torch.Tensor:
        return sum(-torch.sum(torch.softmax(l, dim=-1) * torch.log_softmax(l, dim=-1), dim=-1)
                   for l in self.logits)


class TwoHot(NamedTuple):
    """A categorical over `n` evenly spaced bins on [low, high] whose mean
    interpolates between bins; `log_prob` is the cross-entropy against the
    two-hot encoding of a scalar value (..., 1) (JAX `TwoHot`)."""

    logits: torch.Tensor
    low: float = -20.0
    high: float = 20.0

    @property
    def support(self) -> torch.Tensor:
        """The bins, low * (1 - s) + high * s at s = i / (n - 1): the
        rounding of `jnp.linspace`, which fixes in which bin a value on an
        edge falls."""
        n = self.logits.shape[-1]
        s = torch.arange(n, dtype=torch.float32, device=self.logits.device) / (n - 1)
        return self.low * (1.0 - s) + self.high * s

    @property
    def mean(self) -> torch.Tensor:
        return torch.sum(torch.softmax(self.logits, dim=-1) * self.support, dim=-1, keepdim=True)

    @property
    def mode(self) -> torch.Tensor:
        return self.mean

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        support = self.support
        n = support.shape[0]
        v = torch.clamp(value[..., 0], self.low, self.high)
        idx = torch.clamp(torch.searchsorted(support, v.contiguous(), right=True) - 1, 0, n - 2)
        lo, hi = support[idx], support[idx + 1]
        w_hi = (v - lo) / (hi - lo)
        logp = torch.log_softmax(self.logits, dim=-1)
        lp_lo = torch.gather(logp, -1, idx[..., None])[..., 0]
        lp_hi = torch.gather(logp, -1, idx[..., None] + 1)[..., 0]
        return (1.0 - w_hi) * lp_lo + w_hi * lp_hi
