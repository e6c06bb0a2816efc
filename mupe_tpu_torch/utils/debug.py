"""Failure detection (counterpart of mupe_tpu/utils/debug.py; its profiler
trace is `utils/trace.profile_trace`):

- `check_finite`: whether every floating tensor of a tree is finite, with a
  per-leaf report;
- `guard_train_iter`: wraps a train iteration so that one whose loss went
  non-finite leaves the carry as it found it, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch import nn

from . import trace


def _leaves(obj: Any, path: str = ""):
    """(path, tensor) for every tensor of a tensor / module / dataclass /
    dict / list / tuple tree."""
    if isinstance(obj, torch.Tensor):
        yield path, obj
    elif isinstance(obj, nn.Module):
        for k, v in obj.state_dict(keep_vars=True).items():
            yield f"{path}.{k}", v
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{path}[{i}]")


def check_finite(tree: Any) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(all finite, {leaf path: finite}) over the floating tensors of
    `tree`, as device booleans (no host sync)."""
    report = {p: torch.all(torch.isfinite(t)) for p, t in _leaves(tree)
              if t.is_floating_point()}
    all_ok = (torch.all(torch.stack(list(report.values()))) if report
              else torch.tensor(True))
    return all_ok, report


class _Snapshot:
    """What a train iteration may change in a carry, kept so it can be put
    back bit for bit: every container's references (a dataclass's fields,
    a dict's items, a list's elements), a copy of every tensor's data and
    every generator's state.  The port's iteration updates its parameters
    and optimizer moments in place and replaces the rest, so both halves
    are needed; a tensor's data is copied back only where its version
    counter says it was written in place."""

    def __init__(self, root: Any):
        self.refs: List[Tuple[Any, Any]] = []
        self.data: List[Tuple[torch.Tensor, int, torch.Tensor]] = []
        self.gens: List[Tuple[torch.Generator, torch.Tensor]] = []
        self._seen: set = set()
        self._take(root)

    def _take(self, obj: Any) -> None:
        if id(obj) in self._seen:
            return
        self._seen.add(id(obj))
        if isinstance(obj, torch.Tensor):
            self.data.append((obj, obj._version, obj.detach().clone()))
        elif isinstance(obj, torch.Generator):
            self.gens.append((obj, obj.get_state()))
        elif isinstance(obj, nn.Module):
            for t in obj.state_dict(keep_vars=True).values():
                self._take(t)
        elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            fields = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
            self.refs.append((obj, fields))
            for v in fields.values():
                self._take(v)
        elif isinstance(obj, dict):
            self.refs.append((obj, dict(obj)))
            for v in obj.values():
                self._take(v)
        elif isinstance(obj, (list, tuple)):
            if isinstance(obj, list):
                self.refs.append((obj, list(obj)))
            for v in obj:
                self._take(v)

    @torch.no_grad()
    def restore(self) -> None:
        for obj, saved in self.refs:
            if isinstance(obj, dict):
                obj.clear()
                obj.update(saved)
            elif isinstance(obj, list):
                obj[:] = saved
            else:
                for k, v in saved.items():
                    object.__setattr__(obj, k, v)
        for t, version, saved in self.data:
            if t._version != version:  # written in place since the snapshot
                t.copy_(saved)
        for g, state in self.gens:
            g.set_state(state)


def guard_train_iter(train_iter: Callable, metric_key: str = "policy_loss") -> Callable:
    """Failure-detection wrapper: snapshot the carry, run the iteration,
    read one scalar metric on the host; if it is non-finite, put the carry
    back as it was (parameters, Adam moments and counts, value normaliser,
    entropy coefficient, env state, observation, critic state, generator
    state) and return it with the stats flagged `nan_skipped` = 1.  Costs a
    copy of the carry and one scalar sync an iteration."""

    def wrapped(carry, *args, **kwargs):
        snap = _Snapshot(carry)
        new_carry, metrics, stats = train_iter(carry, *args, **kwargs)
        with trace.span("sync.guard_nan"):
            finite = bool(torch.isfinite(torch.as_tensor(metrics[metric_key])))
        if not finite:
            snap.restore()
            flag = torch.ones((), device=torch.as_tensor(metrics[metric_key]).device)
            return carry, metrics, {**stats, "nan_skipped": flag}
        return new_carry, metrics, stats

    return wrapped

