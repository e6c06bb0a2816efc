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
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class KernelTol:
    max_rel: float   # largest |error|, as a share of the largest |plain output|
    mean_rel: float  # mean |error|, as a share of the mean |plain output|

    def errors(self, out: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
        diff = (out - ref).abs()
        max_abs = diff.max().item()
        return {
            "max_abs": max_abs,
            "max_rel": max_abs / max(ref.abs().max().item(), 1e-30),
            "mean_rel": diff.mean().item() / max(ref.abs().mean().item(), 1e-30),
        }

    def holds(self, errs: Dict[str, float]) -> bool:
        """False for NaN errors as well as for large ones."""
        return errs["max_rel"] <= self.max_rel and errs["mean_rel"] <= self.mean_rel


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

    def errors(self, outs: Sequence[torch.Tensor], refs: Sequence[torch.Tensor]) -> List[Dict]:
        net_scale = max(r.abs().max().item() for r in refs)
        rows = []
        for i, (o, r) in enumerate(zip(outs, refs)):
            errs = KernelTol(self.max_rel, self.mean_rel).errors(o, r)
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
            if not (e["max_rel"] <= limit and e["mean_rel"] <= self.mean_rel):
                bad.append(i)
        return bad

    def holds(self, errs: List[Dict]) -> bool:
        return not self.failing(errs)
