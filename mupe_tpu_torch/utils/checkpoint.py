"""Checkpoint / resume with `torch.save` (counterpart of
mupe_tpu/utils/checkpoint.py).

`harness.train` writes two artifacts per save:

  * ``step_N``: the learner state (`MAPPOState`: parameters, both Adam
    states, the TP net and its Adam state, `ValueNorm1`, the entropy
    coefficient), the `model_dir` warm-start target;
  * ``full/step_N``: the whole `IterCarry`: learner state, env state with
    its curriculum scalars (`v_prey`, `update_epoch`) and the AEG
    `GenBufferState`, the last observation and the generator's state, the
    `resume_dir` target for exact resume.

A checkpoint is a plain nested dict of CPU tensors (dataclasses and modules
become dicts of their fields and parameters; a generator its `get_state()`),
read back with `torch.load(weights_only=True)` and copied into a target of
the same structure on the target's devices.  A checkpoint that lacks a
leaf of the target (the learner state given where the full carry is wanted,
or the other way round) is refused.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Optional

import torch
from torch import nn


def to_plain(obj: Any) -> Any:
    """Tensors, modules, generators, dataclasses, dicts and lists → nested
    dicts and lists of CPU tensors and Python scalars."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, torch.Generator):
        return obj.get_state()
    if isinstance(obj, nn.Module):
        return {k: v.detach().cpu().clone() for k, v in obj.state_dict().items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_plain(v) for v in obj]
    return obj


def restore(target: Any, saved: Any, path: str = "") -> Any:
    """`target` with every leaf taken from `saved` (a `to_plain` tree): new
    tensors on the target's devices, modules and generators loaded in
    place.  Raises KeyError with the path of a leaf `saved` lacks."""
    if isinstance(target, torch.Tensor):
        return saved.to(device=target.device, dtype=target.dtype)
    if isinstance(target, torch.Generator):
        target.set_state(saved)
        return target
    if isinstance(target, nn.Module):
        target.load_state_dict(saved)
        return target
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        return dataclasses.replace(target, **{
            f.name: _field(getattr(target, f.name), saved, f.name, path)
            for f in dataclasses.fields(target)})
    if isinstance(target, dict):
        return {k: _field(v, saved, k, path) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if not isinstance(saved, list) or len(saved) != len(target):
            raise KeyError(f"{path}[{len(target) - 1}]")
        return type(target)(restore(t, s, f"{path}[{i}]")
                            for i, (t, s) in enumerate(zip(target, saved)))
    return saved  # a Python scalar, or None


def _field(target, saved, key, path):
    if not isinstance(saved, dict) or key not in saved:
        raise KeyError(f"{path}.{key}")
    return restore(target, saved[key], f"{path}.{key}")


def save_checkpoint(path: str | Path, step: int, payload: Any) -> Path:
    """Write `payload` to `path/step_<step>`."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    out = path / f"step_{step}"
    torch.save(to_plain(payload), out)
    return out


def load_checkpoint(path: str | Path, target: Optional[Any] = None) -> Any:
    """Load the latest `step_*` under `path` (or `path` itself).  With a
    `target`, return it filled from the checkpoint; else the plain tree."""
    path = Path(path)
    if path.name.startswith("step_") and path.is_file():
        latest = path
    else:
        steps = sorted(path.glob("step_*"), key=lambda p: int(p.name.split("_")[1]))
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {path}")
        latest = steps[-1]
    saved = torch.load(latest, map_location="cpu", weights_only=True)
    if target is None:
        return saved
    try:
        return restore(target, saved)
    except KeyError as e:
        raise ValueError(f"checkpoint {latest} does not fit the restore target: "
                         f"it lacks {e.args[0]}") from None
