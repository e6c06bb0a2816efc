"""The program's spans and counters, on the profiler's clock.

`span(name)` marks a stretch of the program by its role (`env.step`,
`update.ppo`, `kernel.pair_bwd`, `sync.any_across`, ...; the list is in
PERF.md's layers).  It always counts: `counts()[name]` is the number of
times the span was entered, whatever else runs.  Nothing else happens
unless a `torch.profiler` is recording.  Then each span keeps a record
(its name, the spans open around it, its root, host times and, once CUDA
is initialised, a CUDA event pair), and a span that holds no other span
opens a `torch.profiler.record_function` range of its name: the range
sits on the profiler's clock, in the same trace as the device's kernels,
so an idle gap of the device is named by the program's innermost work.
Spans that hold others (`GROUPS`) open no range, so they do not hide the
names of the work inside them.

One stack serves the whole process, not one a thread: the main thread
waits inside `backward()` while autograd's thread runs the kernels'
backward, so those spans take the update's span as their parent.

- `launching()`: a kernel wrapper's launch starts its span's device clock;
- `to_device(value, device)`: a copy from the host, as a `sync.*` span;
- `recorded()`: the records, with device, host and self milliseconds;
- `clear()`: forget the records;
- `profile_trace(logdir)`: a profiler over a block, written as
  `trace.json` (Chrome trace) and `spans.json` (each span's count and
  milliseconds).
"""
from __future__ import annotations

import collections
import contextlib
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

# spans that hold other spans: they open no profiler range
GROUPS = frozenset({"train.iter", "eval.episode", "rollout", "policy.act", "env.step",
                    "update", "update.tp", "update.ppo", "update.actor", "update.critic",
                    "vision.backbone", "graph.eager", "graph.capture"})
# spans that start a tree: every span inside shares their index as `root`
ROOTS = frozenset({"train.iter", "eval.episode"})

_counts: collections.Counter = collections.Counter()
_stack: List["_Record"] = []
_records: List["_Record"] = []
_cache: Optional[List[Dict[str, Any]]] = None
_recording = torch.autograd._profiler_enabled


class _Record:
    __slots__ = ("name", "index", "parent", "root", "path", "t0", "t1", "events", "rf",
                 "launched")

    def __init__(self, name: str):
        parent = _stack[-1] if _stack else None
        self.name = name
        self.index = len(_records)
        self.parent = parent.index if parent is not None else None
        self.path = parent.path + (parent.name,) if parent is not None else ()
        self.root = self.index if name in ROOTS else (parent.root if parent is not None else None)
        self.rf = None
        if name not in GROUPS:
            self.rf = torch.profiler.record_function(name)
            self.rf.__enter__()
        self.events, self.launched = None, False
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t1 = None
        self.t0 = time.perf_counter_ns()

    def close(self) -> None:
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)


class span:
    """`with span(name):` counts the stretch, and records it while a
    profiler records."""

    __slots__ = ("name", "_rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        global _cache
        _counts[self.name] += 1
        if _recording():
            self._rec = rec = _Record(self.name)
            _stack.append(rec)
            _records.append(rec)
            _cache = None
        else:
            self._rec = None
        return self

    def __exit__(self, *exc) -> None:
        global _cache
        if self._rec is not None:  # spans close in the order opposite to their opening
            self._rec.close()
            _stack.pop()
            _cache = None


def launching() -> None:
    """Called by a kernel wrapper right before it launches: the device
    clock of the innermost open `kernel.*` span starts at its first launch,
    so the host's preparation before it is not counted as the kernel's."""
    rec = _stack[-1] if _stack else None
    if rec is not None and not rec.launched and rec.name.startswith("kernel."):
        rec.launched = True
        if rec.events is not None:
            rec.events[0].record()


def to_device(value, device, dtype=None, site: str = "to_device") -> torch.Tensor:
    """`torch.as_tensor(value, dtype, device)`.  A copy from the host waits
    for the device's queue: it is the span `sync.<site>`."""
    if isinstance(value, torch.Tensor) and value.device.type == torch.device(device).type:
        return value if dtype is None else value.to(dtype)
    with span(f"sync.{site}"):
        return torch.as_tensor(value, dtype=dtype, device=device)


def counts() -> collections.Counter:
    """How often each span was entered (0 for a name never entered); the
    live counter, which a graph's replay adds its capture's counts to."""
    return _counts


def clear() -> None:
    """Forget the records (the counts stay); outside any span."""
    global _cache
    _records.clear()
    _cache = None


def _union_ms(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def recorded() -> List[Dict[str, Any]]:
    """Every record, in the order the spans opened: `name`, `index` (its
    place in this list), `parent` and `root` (indices, or None), `path`
    (the names of the spans open around it, outermost first), `host_ms`,
    `device_ms` (between its CUDA events, None without them) and `self_ms`
    (its duration less the union of its children's, on the device's clock
    where it has events, else on the host's); the times are None while a
    span is open.  One synchronisation."""
    global _cache
    if _cache is not None:
        return _cache
    timed = [r for r in _records if r.events is not None and r.t1 is not None]
    if timed:
        torch.cuda.synchronize()
        origin = timed[0].events[0]
    out, spans = [], {}
    t_origin = _records[0].t0 if _records else 0
    for r in _records:
        host = dev = None
        if r.t1 is not None:
            host = (r.t1 - r.t0) * 1e-6
            spans[r.index] = ((r.t0 - t_origin) * 1e-6, (r.t1 - t_origin) * 1e-6)
            if r.events is not None:
                dev = r.events[0].elapsed_time(r.events[1])
                start = origin.elapsed_time(r.events[0])
                spans[r.index] = (start, start + dev)
        out.append({"name": r.name, "index": r.index, "parent": r.parent, "root": r.root,
                    "path": r.path, "host_ms": host, "device_ms": dev,
                    "self_ms": dev if dev is not None else host})
    children = collections.defaultdict(list)
    for r in out:
        if r["parent"] is not None and r["index"] in spans:
            children[r["parent"]].append(spans[r["index"]])
    for parent, kids in children.items():
        if parent in spans:
            s0, e0 = spans[parent]
            inside = [(max(s, s0), min(e, e0)) for s, e in kids if min(e, e0) > max(s, s0)]
            out[parent]["self_ms"] -= _union_ms(inside)
    _cache = out
    return out


def summary(records: List[Dict[str, Any]]) -> Dict[str, Dict[str, float]]:
    """Each name's count, and its total and self milliseconds (the
    device's where recorded, else the host's)."""
    out: Dict[str, Dict[str, float]] = {}
    for r in records:
        if r["host_ms"] is None:
            continue
        s = out.setdefault(r["name"], {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
        s["count"] += 1
        s["total_ms"] += r["device_ms"] if r["device_ms"] is not None else r["host_ms"]
        s["self_ms"] += r["self_ms"]
    return out


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the enclosed block and write `logdir/trace.json` (a Chrome
    trace: the host's PyTorch ops and the program's span ranges and, with
    a card, its kernels, copies and the runtime calls that launch them)
    and `logdir/spans.json` (`summary` of the block's spans, those without
    a range too).  The trace is large: 3 training iterations at 4096
    arenas wrote 587 MB in ~37 s on an H100 (362 MB, ~19 s, for the CUDA
    activity alone)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    first = len(_records)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))
    mine = [r for r in recorded() if r["index"] >= first]
    (Path(logdir) / "spans.json").write_text(json.dumps(summary(mine), indent=1))
