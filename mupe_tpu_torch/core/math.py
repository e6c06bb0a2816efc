"""Small tensor-math helpers (counterpart of mupe_tpu/core/math.py)."""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def const(values, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`values` (a number or a nested tuple) as a tensor on `device`, made
    once: a tensor built from host data every step would wait for the
    device.  The result is shared: never write into it."""
    return torch.tensor(values, dtype=dtype, device=torch.device(device))


def off_diag(a: torch.Tensor) -> torch.Tensor:
    """Drop the diagonal of an (n, n, ...) pairwise tensor → (n, n-1, ...)."""
    n = a.shape[0]
    rest = tuple(a.shape[2:])
    return (
        a.reshape((n * n,) + rest)[1:]
        .reshape((n - 1, n + 1) + rest)[:, :-1]
        .reshape((n, n - 1) + rest)
    )


def cpos(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Pairwise relative positions p1[i] - p2[j] → (n1, n2, d)."""
    return p1[:, None, :] - p2[None, :, :]


def normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log(torch.abs(x) + 1.0)


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)
