"""Trajectory ring buffer (counterpart of mupe_tpu/learning/mybuffer.py;
reference `MyBuffer`, omni_drones/learning/common.py:42-81).

A ring over the time axis: every leaf of `storage` is [capacity, E, ...];
`extend` writes T new time steps (time-major) at the cursor, wrapping, and
`sample` draws (env, contiguous window) sub-trajectories.  Windows start
at the oldest valid row, (cursor - length) mod capacity, so they may wrap in
storage but never stitch the newest step onto the oldest across the seam.
The draws are the caller's (`env_idx`, `t0`) or come from a generator.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from .mappo import tree_map


def _first_leaf(tree) -> torch.Tensor:
    return _first_leaf(next(iter(tree.values()))) if isinstance(tree, dict) else tree


@dataclasses.dataclass
class TrajRingBuffer:
    """Ring over the TIME axis; leaves are [capacity, E, ...]."""

    storage: Any
    cursor: torch.Tensor   # [] int64, the next row written
    length: torch.Tensor   # [] int64, the valid rows (<= capacity)

    @property
    def capacity(self) -> int:
        return _first_leaf(self.storage).shape[0]

    @classmethod
    def create(cls, example, capacity: int) -> "TrajRingBuffer":
        """`example` is one time slice: a tensor or dict of tensors [E, ...]."""
        storage = tree_map(lambda x: torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype,
                                                 device=x.device), example)
        dev = _first_leaf(storage).device
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return cls(storage=storage, cursor=zero, length=zero.clone())


def _map2(fn, a, b):
    """`fn` on each pair of tensors of two trees of one structure."""
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def extend(buf: TrajRingBuffer, data) -> TrajRingBuffer:
    """Append a time-major chunk (leaves [T, E, ...]) at the cursor,
    wrapping.  The storage is written in place; the returned buffer carries
    the new cursor and length."""
    t = _first_leaf(data).shape[0]
    cap = buf.capacity
    rows = (buf.cursor + torch.arange(t, device=buf.cursor.device)) % cap
    _map2(lambda s, d: s.index_copy_(0, rows, d.to(s.dtype)), buf.storage, data)
    return TrajRingBuffer(storage=buf.storage, cursor=(buf.cursor + t) % cap,
                          length=torch.clamp(buf.length + t, max=cap))


def sample(buf: TrajRingBuffer, batch_size: int, seq_len: int,
           generator: Optional[torch.Generator] = None, env_idx: Optional[torch.Tensor] = None,
           t0: Optional[torch.Tensor] = None) -> Tuple[Any, torch.Tensor]:
    """`batch_size` windows of `seq_len` steps: leaves [batch_size, seq_len,
    ...], and the mask [batch_size] of windows drawn while the buffer held at
    least `seq_len` rows (a short buffer gives flagged windows rather than
    raising).  The env of each window (`env_idx`, uniform over E) and its
    start in time (`t0`, uniform over [0, max(length - seq_len, 1))) are
    given, or drawn from `generator`."""
    leaf = _first_leaf(buf.storage)
    e, cap, dev = leaf.shape[1], buf.capacity, leaf.device
    if env_idx is None:
        env_idx = torch.randint(0, e, (batch_size,), generator=generator, device=dev)
    if t0 is None:
        high = torch.clamp(buf.length - seq_len, min=1)
        t0 = torch.floor(torch.rand((batch_size,), generator=generator, device=dev)
                         * high).long()
    oldest = (buf.cursor - buf.length) % cap
    rows = (oldest + t0[:, None] + torch.arange(seq_len, device=dev)[None, :]) % cap   # [B, S]
    batch = tree_map(lambda s: s[rows, env_idx[:, None]], buf.storage)
    valid = (buf.length >= seq_len).expand(batch_size)
    return batch, valid


def size(buf: TrajRingBuffer) -> torch.Tensor:
    """len(buffer)."""
    return buf.length
