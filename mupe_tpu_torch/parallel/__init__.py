"""Data parallelism over the arena axis (counterpart of mupe_tpu/parallel/)."""
from .dist import (
    EnvShard,
    all_gather_envs,
    all_reduce_max,
    all_reduce_sum,
    any_across,
    broadcast,
    gather_carry,
    global_sum,
    init_distributed,
    local_device,
    local_env_slice,
    rank,
    shard_carry,
    world_size,
)

__all__ = [
    "EnvShard",
    "all_gather_envs",
    "all_reduce_max",
    "all_reduce_sum",
    "any_across",
    "broadcast",
    "gather_carry",
    "global_sum",
    "init_distributed",
    "local_device",
    "local_env_slice",
    "rank",
    "shard_carry",
    "world_size",
]
