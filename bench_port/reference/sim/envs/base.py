"""Environment core: the transition record, the done-select and the env
registry (counterpart of mupe_tpu/envs/base.py)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch


@dataclasses.dataclass
class Transition:
    """One vectorized env transition.  ``obs`` is the observation after the
    step (and after any auto-reset); ``stats`` is the stats snapshot taken
    when the step completed, episode-normalized where ``done`` is set."""

    obs: Any
    reward: torch.Tensor
    done: torch.Tensor
    stats: Dict[str, torch.Tensor]
    info: Dict[str, Any]


def where_done(done: torch.Tensor, reset_val: Any, old_val: Any) -> Any:
    """Take `reset_val` where done else `old_val`, leaf by leaf over tensors,
    dicts and dataclasses.  `done` has shape [num_envs]."""
    if isinstance(reset_val, torch.Tensor):
        d = done.reshape(done.shape + (1,) * (reset_val.dim() - done.dim()))
        return torch.where(d, reset_val, old_val)
    if isinstance(reset_val, dict):
        return {k: where_done(done, reset_val[k], old_val[k]) for k in reset_val}
    if dataclasses.is_dataclass(reset_val):
        return dataclasses.replace(
            reset_val,
            **{
                f.name: where_done(done, getattr(reset_val, f.name), getattr(old_val, f.name))
                for f in dataclasses.fields(reset_val)
            },
        )
    raise TypeError(f"where_done: unsupported leaf {type(reset_val)}")


ENV_REGISTRY: Dict[str, Callable] = {}


def register_env(name: str):
    """Env class registry under the name and its lower case
    (mupe_tpu/envs/base.py:55-66)."""

    def deco(cls):
        ENV_REGISTRY[name] = cls
        ENV_REGISTRY[name.lower()] = cls
        return cls

    return deco


def tree_to(obj: Any, device) -> Any:
    """Copy every tensor of a tensor / dict / list / tuple / dataclass tree
    to `device`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: tree_to(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(tree_to(v, device) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(
            obj, **{f.name: tree_to(getattr(obj, f.name), device)
                    for f in dataclasses.fields(obj)}
        )
    return obj
