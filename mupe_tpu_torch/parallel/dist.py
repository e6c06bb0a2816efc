"""Data parallelism over the arena axis with `torch.distributed`
(counterpart of mupe_tpu/parallel/mesh.py).

The JAX package shards the arena axis of the env state over a device mesh
and lets XLA's partitioner insert the collectives, so its sharded program
is its one-device program.  The port keeps that contract by hand: R ranks
that each hold E / R arenas compute the iteration one rank computes over E
arenas.

* Every rank holds the same generator, seeded alike, and every draw of the
  env and of the action noise is made at the global arena count; each rank
  keeps its own rows (`EnvShard.draw`).  The generators stay in lockstep,
  so the minibatch permutations and the learner's initialisation agree on
  every rank without a broadcast.
* Host branches that gate a draw decide on the global flag (`any_across`).
* The update's means divide by global counts, its statistics and
  gradients are summed over the ranks (`all_reduce_sum`) before the
  optimizers, so every rank applies the same bits: the learner is
  replicated.
* Rank r owns the contiguous arenas [r E / R, (r + 1) E / R);
  `all_gather_envs` joins the ranks' rows in that order, `gather_carry`
  builds the one-rank carry for a checkpoint and `shard_carry` slices a
  one-rank carry for resume.

Without a process group every collective is the identity, and a shard is
the whole arena axis.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as tdist
from torch import nn

from ..utils import trace


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None) -> bool:
    """Join the process group (JAX's `init_distributed`).  The arguments
    default to torchrun's `WORLD_SIZE`, `RANK` and `MASTER_ADDR` /
    `MASTER_PORT` (`init_method="env://"`).  A single process (no world
    size given or set) is a no-op.  `backend` defaults to "nccl" where CUDA
    is available and "gloo" otherwise.  Where a world size is asked for and
    the group cannot form, it raises; it never falls back to one rank.
    Returns whether a process group exists."""
    if is_initialized():
        return True
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None:
        return False
    if rank is None:
        raise ValueError(f"world size {world_size} without a rank (set RANK or pass rank=)")
    if init_method is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError(f"world size {world_size}: no init_method and no "
                             "MASTER_ADDR / MASTER_PORT to form the group")
        init_method = "env://"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if backend == "nccl":
        # bind the group to this rank's card before the first collective
        kw["device_id"] = local_device()
    tdist.init_process_group(backend=backend, init_method=init_method, world_size=world_size,
                             rank=rank, timeout=datetime.timedelta(minutes=10), **kw)
    return True


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def rank() -> int:
    return tdist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def local_device(device: torch.device | str = "cuda") -> torch.device:
    """This rank's device: the CPU where the caller asks for it, else
    `cuda:LOCAL_RANK` (modulo the visible cards, so ranks may share one
    card, which the gloo backend allows and NCCL refuses)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    count = torch.cuda.device_count()
    return torch.device("cuda", local % count if count else 0)


def destroy() -> None:
    """Leave the process group, if any."""
    if is_initialized():
        tdist.destroy_process_group()


# ------------------------------------------------------------------ the shard
@dataclasses.dataclass(frozen=True)
class EnvShard:
    """This rank's contiguous arenas [offset, offset + size) of `total`."""

    offset: int
    size: int
    total: int

    @classmethod
    def of(cls, num_envs: int, rank_: Optional[int] = None,
           world: Optional[int] = None) -> "EnvShard":
        """Rank `rank_`'s arenas of `num_envs` over `world` ranks (the
        current group's by default).  Raises ValueError unless the world
        size divides `num_envs` (JAX's `sharded_init_jit` fails there too)."""
        world = world_size() if world is None else world
        rank_ = rank() if rank_ is None else rank_
        if num_envs % world != 0:
            raise ValueError(f"num_envs {num_envs} is not divisible by the world size {world}")
        per = num_envs // world
        return cls(offset=per * rank_, size=per, total=num_envs)

    @property
    def full(self) -> bool:
        return self.size == self.total

    @property
    def slice(self) -> slice:
        return slice(self.offset, self.offset + self.size)

    def rows(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This rank's rows of a global tensor (`axis` is the arena axis)."""
        if self.full:
            return x
        return x.narrow(axis, self.offset, self.size)

    def draw(self, sample: Callable[[tuple], torch.Tensor], shape: Sequence[int],
             axis: int = 0) -> torch.Tensor:
        """`sample(shape)` made at the global arena count on `axis`, this
        rank's rows kept: the draw a one-rank run makes, so every rank's
        generator advances alike."""
        shape = tuple(shape)
        if self.full:
            return sample(shape)
        if shape[axis] != self.size:
            raise ValueError(f"draw of shape {shape}: axis {axis} is not this rank's "
                             f"{self.size} arenas")
        full = shape[:axis] + (self.total,) + shape[axis + 1:]
        return sample(full).narrow(axis, self.offset, self.size).contiguous()


def local_cfg(cfg: Any, shard: Optional[EnvShard]) -> tuple:
    """(`cfg` with `num_envs` this shard's arenas, the shard): an env of
    the global configuration `cfg` holds `shard`'s arenas, all of them
    without one."""
    shard = EnvShard.of(cfg.num_envs, 0, 1) if shard is None else shard
    if shard.total != cfg.num_envs:
        raise ValueError(f"shard of {shard.total} arenas for num_envs {cfg.num_envs}")
    return dataclasses.replace(cfg, num_envs=shard.size), shard


def local_env_slice(num_envs: int) -> slice:
    """This rank's contiguous slice of the global arena axis."""
    return EnvShard.of(num_envs).slice


# ------------------------------------------------------------ collectives
# NCCL takes CUDA tensors and gloo both CPU and CUDA ones (gloo stages CUDA
# tensors through host memory itself)
def _in_place(x: torch.Tensor, op: Callable[[torch.Tensor], Any]) -> torch.Tensor:
    """The in-place collective `op` on a contiguous copy of `x`."""
    y = x.detach().clone(memory_format=torch.contiguous_format)
    op(y)
    return y


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of `x` over the ranks (a new tensor; `x`
    itself without a group)."""
    if not is_initialized():
        return x
    return _in_place(x, lambda y: tdist.all_reduce(y, op=tdist.ReduceOp.SUM))


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, whose gradient is the sum over the ranks of
    each rank's gradient: every rank's share of a loss differentiated
    through statistics of every rank's rows (SyncBatchNorm's seam)."""

    @staticmethod
    def forward(ctx, x):
        return _in_place(x, lambda y: tdist.all_reduce(y, op=tdist.ReduceOp.SUM))

    @staticmethod
    def backward(ctx, grad):
        return _in_place(grad, lambda y: tdist.all_reduce(y, op=tdist.ReduceOp.SUM))


def all_reduce_sum_grad(x: torch.Tensor) -> torch.Tensor:
    """`all_reduce_sum`, differentiable: its backward is a collective too,
    so every rank must run the backward of each call (`x` itself without a
    group)."""
    if not is_initialized():
        return x
    return _AllReduceSum.apply(x)


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of `x` over the ranks."""
    if not is_initialized():
        return x
    return _in_place(x, lambda y: tdist.all_reduce(y, op=tdist.ReduceOp.MAX))


def all_reduce_tensors(tensors: Sequence[torch.Tensor]) -> list:
    """Each tensor of a list summed over the ranks, in one collective."""
    if not is_initialized():
        return list(tensors)
    flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in tensors]))
    return [part.reshape(t.shape) for part, t in
            zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]


def broadcast(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank `src`'s `x` on every rank."""
    if not is_initialized():
        return x
    return _in_place(x, lambda y: tdist.broadcast(y, src=src))


def all_gather_envs(x: torch.Tensor) -> torch.Tensor:
    """Every rank's `x` joined along axis 0 in rank order: the global
    arena axis from the ranks' shards (all of equal size)."""
    if not is_initialized() or world_size() == 1:
        return x
    y = x.detach().contiguous()
    parts = [torch.empty_like(y) for _ in range(world_size())]
    tdist.all_gather(parts, y)
    return torch.cat(parts, dim=0)


def any_across(flag: torch.Tensor) -> bool:
    """Whether any element of `flag` is set on any rank (one host read;
    one collective with a group).  Host branches that gate a draw decide
    on this, so every rank draws alike."""
    hit = torch.any(flag).to(torch.int32).reshape(1)
    with trace.span("sync.any_across"):
        return bool(all_reduce_max(hit).item())


def global_sum(x: torch.Tensor, dims=None) -> torch.Tensor:
    """The sum of `x` over `dims` (all by default) and over the ranks."""
    s = torch.sum(x) if dims is None else torch.sum(x, dim=dims)
    return all_reduce_sum(s)


# -------------------------------------------------------- carry shard / gather
# The fields of the env states that every rank holds whole: the curriculum
# scalars, the replicated AEG buffer, the drone zoo's unbatched leaves.
REPLICATED_FIELDS = ("v_prey", "update_epoch", "gen", "directions")
# The carry's learner and generator are replicated; the rest is per-arena.
_CARRY_REPLICATED = ("ts", "generator")


def _map_arena_leaves(obj: Any, fn: Callable[[torch.Tensor], torch.Tensor],
                      replicated: Sequence[str] = REPLICATED_FIELDS) -> Any:
    """`obj` with `fn` applied to every per-arena tensor: every tensor of
    at least one dimension under a field not named in `replicated`."""
    if isinstance(obj, torch.Tensor):
        return fn(obj) if obj.dim() >= 1 else obj
    if isinstance(obj, (torch.Generator, nn.Module)):
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: (getattr(obj, f.name) if f.name in replicated
                     else _map_arena_leaves(getattr(obj, f.name), fn, REPLICATED_FIELDS))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: _map_arena_leaves(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_map_arena_leaves(v, fn) for v in obj)
    return obj


def shard_carry(carry: Any, shard: EnvShard) -> Any:
    """A one-rank carry (e.g. restored from a checkpoint) sliced to this
    rank's arenas: the env state's per-arena leaves, the observation, the
    critic state and the recurrent states; the learner, the generator and
    the replicated env fields kept whole."""
    if shard.full:
        return carry

    def take(x):
        if x.shape[0] != shard.total:
            raise ValueError(f"per-arena leaf of shape {tuple(x.shape)}: want {shard.total} "
                             "arenas (a checkpoint of another arena count?)")
        return shard.rows(x).clone()

    return _map_arena_leaves(carry, take, _CARRY_REPLICATED)


def gather_carry(carry: Any, shard: EnvShard) -> Any:
    """The one-rank carry from every rank's shard (a collective: every rank
    calls it; each gets the whole), in the format a one-rank run writes."""
    if shard.full:
        return carry

    def join(x):
        if x.shape[0] != shard.size:
            raise ValueError(f"per-arena leaf of shape {tuple(x.shape)}: want this rank's "
                             f"{shard.size} arenas")
        return all_gather_envs(x)

    return _map_arena_leaves(carry, join, _CARRY_REPLICATED)
