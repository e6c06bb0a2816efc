"""CUDA graphs of the sync-free pieces of work: the rollout step's and the
update's minibatch.

At 4,096 arenas an env step is some 670 launches of a few microseconds of
work each, and a PPO minibatch some 150 Python and autograd launches, so
the host's launch rate, not the card, sets their time.  A `Graphed` call
site captures its function once as a `torch.cuda.CUDAGraph` and replays it
afterwards: one graph launch in place of the function's launches.

    site = Graphed()
    out = site(fn, *args, reads=params, flags=(deterministic,), generators=(gen,))

`fn(*generators, *args)` is a function of the tensors in `args` (tensors,
dicts, lists, tuples and dataclasses of them; other leaves are static)
that draws only from `generators` (None: the device's default one) and
reads or writes no host value of a tensor.  Each call copies the input
tensors into the graph's static buffers (one grouped copy a dtype),
replays the graph, and hands out its output tensors as views of one fresh
clone of the graph's packed outputs, so that no later replay overwrites
what a caller kept.  An output that is one of the inputs passes through:
the caller gets its own tensor back.

- **Key.**  A graph is reused while the inputs' structure, shapes, dtypes
  and device, `flags` (the Python values that change the traced code),
  which generators are given and the data pointers of `reads` (every
  tensor the function reads but is not handed: parameters, env constants)
  are the same.  A parameter changed in place is read by the next replay;
  one replaced is a new key and a new capture, and so is an input rebuilt
  every call if it is passed as a `reads` (pass it as an input).  A site
  keeps at most `MAX_GRAPHS` graphs, the least recently used leaving
  first.
- **State.**  `fn` may write in place into `reads` (the update's
  parameters and Adam moments): each replay does so again, as each eager
  call would.  So the first call of a key is the real call, run eagerly
  on the real state; it is also the warm-up, where lazy initialisation
  (kernel modules, cached constants, workspaces) happens outside the
  capture.  The capture follows it on the static buffers and applies
  nothing (a capture runs no kernel); replays start from the next call.
  `fn`'s Python runs in the real call and in the capture, never in a
  replay: what a wrapper of its parts does on the host (the benchmark
  reads Adam's first moments after the first step) happens in the real
  call, and must not happen in the capture.
- **Generators.**  The graph draws from generators of its own, registered
  with it, and a replay moves each given generator's state through its
  own: it draws what the eager call would have drawn and leaves the
  generator where the eager call would.  The device's default generator
  is registered with every graph.
- **When it engages.**  Only where every input is a CUDA tensor, grad is
  disabled at the site (`fn` may enable it inside: autograd's backward is
  captured with the forward) and no capture is running.  A capture happens
  at the first such call of a key, never under `torch.profiler`; elsewhere
  the function runs eagerly.  A caller whose work holds collectives or host
  reads keeps that work off the site: the update with ranks (its
  minibatches' rows, counted on the host, differ by rank, and a gloo
  collective cannot be captured) stays eager.
- **Memory.**  Every graph of a device is captured on one side stream
  into one memory pool: replays run one at a time on the caller's stream
  and each clones its outputs before the next starts, so the graphs'
  intermediates may share memory, and a dead graph's memory serves the
  next capture instead of staying reserved.  Call the sites from one
  stream.
- **Spans.**  Each call opens `graph.replay` or `graph.eager`; a key's
  first call opens `graph.capture` around the real call and the capture.
  A replay adds to `trace.counts()` what its capture counted (the
  `kernel.*` launches, the `env.*` parts), so the counts are those of the
  eager calls.  A capture records two external CUDA events into the graph
  for each `kernel.*` span it holds (`trace.capturing`); a replay under a
  profiler gives each a record below its `graph.replay` span, timed by
  the events that replay recorded (`trace.replayed`), and the graph's next
  replay first reads those times (`trace.freeze`: a wait for the device,
  after a profiled replay only).  Otherwise a replay waits for nothing.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from . import trace

# byte alignment of each output in the packed buffer: the caching
# allocator's, so that a handed-out view sits where a fresh tensor would
_ALIGN = 512
# graphs a call site keeps (training, evaluation and a replaced parameter
# set fit)
MAX_GRAPHS = 4


def flatten(tree) -> Tuple[List[torch.Tensor], Any]:
    """(the tensors of `tree` in a fixed order, its structure): a hashable
    description of the containers and of every non-tensor leaf."""
    leaves: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return None
        if isinstance(x, dict):
            return (dict, tuple(x), tuple(walk(v) for v in x.values()))
        if isinstance(x, (list, tuple)):
            return (type(x), len(x), tuple(walk(v) for v in x))
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            names = tuple(f.name for f in dataclasses.fields(x))
            return (type(x), names, tuple(walk(getattr(x, n)) for n in names))
        return ("leaf", x)

    return leaves, walk(tree)


def unflatten(spec, leaves: Sequence[torch.Tensor]):
    """The tree of `spec` with `leaves` in flatten's order."""
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind = s[0]
        if kind == "leaf":
            return s[1]
        children = [build(c) for c in s[2]]
        if kind is dict:
            return dict(zip(s[1], children))
        if kind in (list, tuple):
            return kind(children)
        if issubclass(kind, tuple):  # a named tuple
            return kind(*children)
        obj = kind.__new__(kind)  # a dataclass: fields set as __init__ would
        for name, child in zip(s[1], children):
            object.__setattr__(obj, name, child)
        return obj

    return build(spec)


# a device's capture stream and the graph that holds its memory pool (the
# module's docstring): a pool lives while a graph captured into it does,
# so this one, of a single node, keeps it between the sites' graphs
_CAPTURE: Dict[torch.device, Tuple[Any, Any]] = {}


def _capture_on(device: torch.device):
    if device not in _CAPTURE:
        stream, holder = torch.cuda.Stream(device), torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            holder.capture_begin(capture_error_mode="thread_local")
            torch.zeros(1, device=device)
            holder.capture_end()
        _CAPTURE[device] = (stream, holder)
    return _CAPTURE[device]


class _Graph:
    """One captured graph: its static inputs, its packed outputs, what its
    capture counted and the kernel spans it holds.  Built right after the
    key's first call, which ran eagerly: the capture applies nothing."""

    def __init__(self, fn: Callable, spec, leaves: List[torch.Tensor], reads,
                 generators: List[Any]):
        dev = leaves[0].device
        stream, holder = _capture_on(dev)
        self.reads = list(reads)  # kept alive while the graph reads them
        self.static = [torch.empty(t.shape, dtype=t.dtype, device=dev) for t in leaves]
        groups: Dict[torch.dtype, List[int]] = collections.defaultdict(list)
        for i, t in enumerate(leaves):
            groups[t.dtype].append(i)
        self.groups = [(idx, [self.static[i] for i in idx]) for idx in groups.values()]
        self.own = [None if g is None else torch.Generator(device=dev) for g in generators]
        self.unread: List[Any] = []  # the kernel records of the last profiled replay

        counts = trace.counts()
        before = counts.copy()
        self.graph = torch.cuda.CUDAGraph()
        for g in self.own:
            if g is not None:
                self.graph.register_generator_state(g)
        current = torch.cuda.current_stream(dev)
        stream.wait_stream(current)
        with torch.cuda.stream(stream), trace.capturing() as self.spans:
            self.graph.capture_begin(holder.pool(), capture_error_mode="thread_local")
            try:
                self._pack(fn(*self.own, *unflatten(spec, self.static)))
            except BaseException:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass  # the capture is void; the first error is the one to see
                raise
            self.graph.capture_end()
        current.wait_stream(stream)
        self.counted = counts - before
        counts.clear()
        counts.update(before)

    def _pack(self, out) -> None:
        """Lay the outputs into one byte buffer (inside the capture): each
        output that is not an input gets a slot, an input passes through."""
        leaves, self.out_spec = flatten(out)
        inputs = {id(t): i for i, t in enumerate(self.static)}
        slot_of: Dict[int, Tuple] = {}
        parts, self.slots, offset, pad = [], [], 0, None
        for t in leaves:
            if id(t) in inputs:
                self.slots.append(("in", inputs[id(t)]))
                continue
            if id(t) not in slot_of:  # an output handed out twice is packed once
                nbytes = t.numel() * t.element_size()
                parts.append(t.reshape(-1).view(torch.uint8))
                room = -nbytes % _ALIGN
                if room:
                    if pad is None:
                        pad = torch.zeros(_ALIGN, dtype=torch.uint8, device=t.device)
                    parts.append(pad[:room])
                shape = tuple(t.shape)
                slot_of[id(t)] = ("out", t.dtype, shape, _contiguous_strides(shape),
                                  offset // t.element_size())
                offset += nbytes + room
            self.slots.append(slot_of[id(t)])
        self.packed = torch.cat(parts) if parts else None
        self.dtypes = sorted({s[1] for s in self.slots if s[0] == "out"}, key=str)

    def copy_in(self, leaves: List[torch.Tensor]) -> None:
        for idx, dst in self.groups:
            torch._foreach_copy_(dst, [leaves[i] for i in idx])

    def replay(self, leaves: List[torch.Tensor], generators: List[Any]):
        self.copy_in(leaves)
        for own, g in zip(self.own, generators):
            if own is not None:
                own.set_state(g.get_state())
        if self.unread:  # the replay records the same events again
            trace.freeze(self.unread)
        self.graph.replay()
        self.unread = trace.replayed(self.spans)
        for own, g in zip(self.own, generators):
            if own is not None:
                g.set_state(own.get_state())
        views = {}
        if self.packed is not None:
            flat = self.packed.clone()
            views = {dt: flat.view(dt) for dt in self.dtypes}
        out = []
        for s in self.slots:
            if s[0] == "in":
                out.append(leaves[s[1]])
            else:
                _, dt, shape, strides, start = s
                out.append(torch.as_strided(views[dt], shape, strides, start))
        trace.counts().update(self.counted)
        return unflatten(self.out_spec, out)


def _contiguous_strides(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(strides))


class Graphed:
    """A call site replayed as CUDA graphs (the module's docstring)."""

    def __init__(self):
        self.graphs: "collections.OrderedDict[Any, _Graph]" = collections.OrderedDict()

    def __call__(self, fn: Callable, *args, reads: Sequence[torch.Tensor] = (),
                 flags: Tuple = (), generators: Sequence[Any] = ()):
        leaves, spec = flatten(args)
        generators = list(generators)
        if not (leaves and not torch.is_grad_enabled()
                and all(t.is_cuda for t in leaves)
                and not torch.cuda.is_current_stream_capturing()):
            with trace.span("graph.eager"):
                return fn(*generators, *args)
        key = (spec, tuple((t.shape, t.dtype, t.device) for t in leaves),
               tuple((r.data_ptr(), r.shape, r.dtype) for r in reads), flags,
               tuple(g is None for g in generators))
        graph = self.graphs.get(key)
        if graph is not None:
            self.graphs.move_to_end(key)
            with trace.span("graph.replay"):
                return graph.replay(leaves, generators)
        if torch.autograd._profiler_enabled():
            with trace.span("graph.eager"):
                return fn(*generators, *args)
        with trace.span("graph.capture"):
            out = fn(*generators, *args)  # the real call, and the capture's warm-up
            self.graphs[key] = _Graph(fn, spec, leaves, reads, generators)
        while len(self.graphs) > MAX_GRAPHS:
            self.graphs.popitem(last=False)
        return out
