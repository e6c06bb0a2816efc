"""One process holds every arena: the parts of mupe_tpu_torch/parallel/dist.py
that the env code calls, without a process group."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class EnvShard:
    """Arenas [offset, offset + size) of `total`; here always all of them."""

    offset: int
    size: int
    total: int

    @classmethod
    def of(cls, num_envs: int, rank_: Optional[int] = None,
           world: Optional[int] = None) -> "EnvShard":
        return cls(offset=0, size=num_envs, total=num_envs)

    @property
    def full(self) -> bool:
        return True

    def draw(self, sample: Callable[[tuple], torch.Tensor], shape: Sequence[int],
             axis: int = 0) -> torch.Tensor:
        return sample(tuple(shape))


def local_cfg(cfg: Any, shard: Optional[EnvShard]) -> tuple:
    return cfg, EnvShard.of(cfg.num_envs)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    return x


def any_across(flag: torch.Tensor) -> bool:
    return bool(torch.any(flag).item())


def global_sum(x: torch.Tensor, dims=None) -> torch.Tensor:
    return torch.sum(x) if dims is None else torch.sum(x, dim=dims)
