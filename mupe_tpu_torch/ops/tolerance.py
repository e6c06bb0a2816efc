"""How far a kernel may stray from its plain version on the same inputs.

A kernel and its plain version round the same operands to bf16 and sum in
f32 in another order, so they part only where a value lies next to a bf16
rounding boundary and rounds one ulp (2^-8 relative) the other way: a few
outputs move by up to a few 1e-3 of the output's scale, the rest hardly at
all.  A kernel that misses a rounding point moves every output.  So each
kernel is held to two limits: on the largest error, which catches a wrong or
dropped row, and on the mean error, which catches a missed rounding point.
The control for the second is the plain version computed in f32 throughout
(`bf16=False`), which must fail it.

A flip early in a row's chain moves the row's later values, which then flip
more of their roundings: over tens of thousands of rows these cascades make
a sum's error depend on how far its terms cancel, which differs from draw to
draw by more than a kernel differs from the control.  So where a limit has a
`floor_mult`, the caller also gives the plain version computed in f64
(`in_f64`: the same rounding points, exact sums): the error of the f32 plain
version against it is the floor, what f32 summation alone costs this output
at this draw, and the limits are at least `floor_mult` times that floor.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch


def in_f64(fn, *args, **kw):
    """fn on f64 copies of its f32 tensor arguments (also inside lists,
    tuples and dicts), its tensor outputs returned in f32: for a plain
    version that keeps its arguments' dtype, the same rounding points with
    (nearly) exact sums."""

    def cast(v, src, dst):
        if isinstance(v, torch.Tensor):
            return v.to(dst) if v.dtype == src else v
        if isinstance(v, (list, tuple)):
            return type(v)(cast(u, src, dst) for u in v)
        if isinstance(v, dict):
            return {k: cast(u, src, dst) for k, u in v.items()}
        return v

    out = fn(*cast(args, torch.float32, torch.float64),
             **cast(kw, torch.float32, torch.float64))
    return cast(out, torch.float64, torch.float32)


def _rel(out: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    diff = (out - ref).abs()
    max_abs = diff.max().item()
    return {
        "max_abs": max_abs,
        "max_rel": max_abs / max(ref.abs().max().item(), 1e-30),
        "mean_rel": diff.mean().item() / max(ref.abs().mean().item(), 1e-30),
    }


@dataclasses.dataclass(frozen=True)
class KernelTol:
    max_rel: float   # largest |error|, as a share of the largest |plain output|
    mean_rel: float  # mean |error|, as a share of the mean |plain output|
    floor_mult: float = 0.0  # with `exact`: each limit at least this times the floor's

    def errors(self, out: torch.Tensor, ref: torch.Tensor,
               exact: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """The errors of `out` against the plain version `ref`, and the
        limits they are held to (with `exact`, the plain version in f64,
        raised to `floor_mult` times the floor)."""
        errs = _rel(out, ref)
        errs["max_limit"], errs["mean_limit"] = self.max_rel, self.mean_rel
        if exact is not None and self.floor_mult:
            floor = _rel(ref, exact)
            errs["max_limit"] = max(self.max_rel, self.floor_mult * floor["max_rel"])
            errs["mean_limit"] = max(self.mean_rel, self.floor_mult * floor["mean_rel"])
        return errs

    def holds(self, errs: Dict[str, float]) -> bool:
        """False for NaN errors as well as for large ones."""
        return (errs["max_rel"] <= errs.get("max_limit", self.max_rel)
                and errs["mean_rel"] <= errs.get("mean_limit", self.mean_rel))


@dataclasses.dataclass(frozen=True)
class GradTol:
    """`KernelTol` for a backward kernel, applied to each gradient leaf.

    A parameter gradient is a sum over tens of thousands of rows, so the two
    sides also add in another order; each leaf is scaled by its own
    magnitude.  Leaves named in `noise_leaves` (an index from the end counts
    too) are analytically zero (the
    softmax's null space makes the key-bias gradient vanish), so both sides
    are rounding noise there: they get no mean check, and their largest
    error is bounded by `noise_floor` of the network's largest gradient."""

    max_rel: float
    mean_rel: float
    noise_floor: float = 0.0
    noise_leaves: Tuple[int, ...] = ()
    floor_mult: float = 0.0  # with `exact`: each mean limit at least this times its floor

    def errors(self, outs: Sequence[torch.Tensor], refs: Sequence[torch.Tensor],
               exact: Optional[Sequence[torch.Tensor]] = None) -> List[Dict]:
        """Per leaf, the errors against the plain version `refs` and the
        mean limit (with `exact`, the plain version in f64, raised to
        `floor_mult` times the leaf's floor)."""
        net_scale = max(r.abs().max().item() for r in refs)
        rows = []
        for i, (o, r) in enumerate(zip(outs, refs)):
            errs = _rel(o, r)
            errs["mean_limit"] = self.mean_rel
            if exact is not None and self.floor_mult:
                errs["mean_limit"] = max(self.mean_rel,
                                         self.floor_mult * _rel(r, exact[i])["mean_rel"])
            if self._noise(i, len(refs)):
                errs["max_rel"] = errs["max_abs"] / max(net_scale, 1e-30)
                errs["mean_rel"] = 0.0
            rows.append(errs)
        return rows

    def _noise(self, i: int, n: int) -> bool:
        return i in self.noise_leaves or i - n in self.noise_leaves

    def failing(self, errs: List[Dict]) -> List[int]:
        """Indices of the leaves that break the limits (NaN breaks them)."""
        bad = []
        for i, e in enumerate(errs):
            limit = self.noise_floor if self._noise(i, len(errs)) else self.max_rel
            if not (e["max_rel"] <= limit and e["mean_rel"] <= e.get("mean_limit", self.mean_rel)):
                bad.append(i)
        return bad

    def holds(self, errs: List[Dict]) -> bool:
        return not self.failing(errs)
