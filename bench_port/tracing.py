"""Spans, annotations and the reduction of a profiler trace, all from the
benchmark's side of the calls into the program.

- `Spans`: CUDA events recorded around calls into a layer (`policy.act`,
  `env.step`, the `mark` callbacks), read once the window has closed, so a
  span adds no synchronisation.
- `Annotations`: named ranges (`torch.profiler.record_function`) opened and
  closed by the benchmark's wrappers in the traced stretch ("bench:rollout",
  "bench:act", ...), which place each kernel's launch in a phase.
- `reduce_trace`: from the profiler's events, the device's busy time (the
  union of its operations' intervals), each kernel with its device time and
  the annotations open when it was launched, the launch calls by phase, the
  device operations that took most time and the idle gaps summed by what
  the host was doing.
"""
from __future__ import annotations

import bisect
import collections
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "bench:"
# host calls that start device work: kernels, and graphs (one call a graph)
LAUNCH_CALLS = ("LaunchKernel", "GraphLaunch")


class Spans:
    """CUDA-event spans by name; `ms(name)` after the window."""

    def __init__(self, device: torch.device):
        self.on = device.type == "cuda"
        self.pairs: Dict[str, List[Tuple[Any, Any]]] = collections.defaultdict(list)

    def event(self):
        if not self.on:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def add(self, name: str, start, end) -> None:
        if self.on:
            self.pairs[name].append((start, end))

    def ms(self, name: str) -> List[float]:
        if self.on:
            torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.pairs.get(name, [])]


class Annotations:
    """Named host ranges for the profiler, opened and closed by hand."""

    def __init__(self):
        self.open: Dict[str, Any] = {}

    def enter(self, name: str) -> None:
        rf = torch.profiler.record_function(PREFIX + name)
        rf.__enter__()
        self.open[name] = rf

    def exit(self, name: str) -> None:
        rf = self.open.pop(name, None)
        if rf is not None:
            rf.__exit__(None, None, None)

    def close_all(self) -> None:
        for name in list(self.open):
            self.exit(name)


def wrap(obj, attr: str, make: Callable[[Callable], Callable]) -> None:
    """Shadow `obj.attr` by `make(original)` on the instance."""
    setattr(obj, attr, make(getattr(obj, attr)))


def unwrap(obj, attr: str) -> None:
    if attr in vars(obj):
        delattr(obj, attr)


def profiler():
    """The profiler over host and device activity."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _events(prof) -> List[Tuple[str, bool, bool, int, int, int]]:
    """(name, on_device, is_annotation, start_ns, end_ns, correlation) of
    every event of the trace."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        dev = ev.device_type() != torch.autograd.DeviceType.CPU
        start = ev.start_ns()
        out.append((ev.name(), dev, bool(ev.is_user_annotation()), start,
                    start + ev.duration_ns(), ev.correlation_id()))
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class _Index:
    """Disjoint outermost host ranges, found by a point."""

    def __init__(self, ranges: List[Tuple[int, int, str]]):
        top, end = [], -1
        for s, e, name in sorted(ranges):
            if s >= end:
                top.append((s, e, name))
                end = e
        self.starts = [r[0] for r in top]
        self.ranges = top

    def at(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.ranges[i][1] >= t:
            return self.ranges[i][2]
        return None


def _open_at(annots: List[Tuple[int, int, str]], t: int) -> Tuple[str, ...]:
    """The benchmark's annotations open at host time t, outermost first."""
    return tuple(name for s, e, name in annots if s <= t <= e)


def reduce_trace(prof, top: int = 10) -> Dict[str, Any]:
    """The traced stretch's device figures: `busy_s`, `kernels` (name,
    device seconds, annotations open at its launch), `launches` (the launch
    calls by the annotations open at each), `device_ops` and `idle_gaps`
    (each the `top` largest, [name, seconds])."""
    evs = _events(prof)
    annots = sorted((s, e, n[len(PREFIX):]) for n, dev, ann, s, e, _ in evs
                    if not dev and n.startswith(PREFIX))
    runtime = {c: s for n, dev, ann, s, e, c in evs
               if not dev and any(k in n for k in LAUNCH_CALLS)}
    device = [(n, s, e, c) for n, dev, ann, s, e, c in evs
              if dev and not ann and not n.startswith(PREFIX)]
    busy = _union([(s, e) for _, s, e, _ in device])
    kernels = []
    by_name: Dict[str, float] = collections.defaultdict(float)
    for n, s, e, c in device:
        launched = runtime.get(c, s)
        kernels.append((n, (e - s) * 1e-9, _open_at(annots, launched)))
        by_name[n] += (e - s) * 1e-9
    launches: Dict[Tuple[str, ...], int] = collections.Counter(
        _open_at(annots, s) for n, dev, ann, s, e, c in evs
        if not dev and any(k in n for k in LAUNCH_CALLS))
    host_ops = _Index([(s, e, n) for n, dev, ann, s, e, _ in evs
                       if not dev and not n.startswith(PREFIX)
                       and not any(k in n for k in LAUNCH_CALLS)])
    gaps: Dict[str, float] = collections.defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) // 2
        where = "/".join(_open_at(annots, mid)) or "outside"
        gaps[f"{where}: {host_ops.at(mid) or 'python'}"] += (s1 - e0) * 1e-9
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "kernels": kernels,
        "launches": dict(launches),
        "device_ops": sorted(([n, t] for n, t in by_name.items()), key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([n, t] for n, t in gaps.items()), key=lambda x: -x[1])[:top],
        # the share of device operations placed by their launch call (the
        # rest by their own start): a check that the trace links them
        "matched_launches": sum(1 for _, _, _, c in device if c in runtime) / max(len(device), 1),
    }


def launches_in(trace: Dict[str, Any], phase: str) -> int:
    """Launch calls made while annotation `phase` was open."""
    return sum(n for open_, n in trace["launches"].items() if phase in open_)


def kernel_seconds(trace: Dict[str, Any], names: Tuple[str, ...], phase: str) -> float:
    """Device seconds of the kernels whose name contains one of `names` and
    that were launched while `phase` was open."""
    return sum(t for n, t, open_ in trace["kernels"]
               if phase in open_ and any(k in n for k in names))
