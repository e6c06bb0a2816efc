"""The comparisons that decide `correct`, shared by the drivers.

Each returns one number: 0 where the program and the reference agree
exactly, growing with the gap.  The limits are each cell's
(`workloads/<cell>.json`, "limits"), set from the readings in PERF.md.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict

import torch

from . import program
from .reference.update import widest_gap


def tree_gap(prog, ref) -> float:
    """The widest gap over every leaf of two trees (dicts of tensors),
    each against the reference leaf's largest value; a leaf missing on
    one side is a gap of infinity."""
    if isinstance(ref, dict):
        if not isinstance(prog, dict) or set(prog) != set(ref):
            return math.inf
        return max((tree_gap(prog[k], ref[k]) for k in ref), default=0.0)
    prog = prog.to(ref.device)
    if prog.dtype == torch.bool or ref.dtype == torch.bool:
        return 0.0 if torch.equal(prog.bool(), ref.bool()) else math.inf
    return widest_gap(prog, ref)


def bf16_state(tree):
    """Every float of a tree rounded to bfloat16 (kept in float32): the
    lower precision of the env's control."""
    if isinstance(tree, torch.Tensor):
        return tree.to(torch.bfloat16).to(tree.dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: bf16_state(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: bf16_state(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


def env_step_gap(snap: Dict[str, Any], ref_env, tp_fn, device, control: bool = False) -> float:
    """The reference's env step from the program's state, action and
    generator state, against what the program's step gave: observation,
    reward, done, episode stats.  The state must also be where the step's
    position says (episodes run from their reset without ending early):
    the program has to hand each step the state the last one returned.
    `control` puts in the program's place the reference stepping from the
    state held in bfloat16."""
    if snap.get("progress") is not None and not torch.all(
            snap["state"].progress == snap["progress"]):
        return math.inf
    state = program.to_reference(program.tree_clone(snap["state"], device),
                                 program.reference_classes())
    args = (tp_fn,) if snap["tp"] else ()
    _, tr = ref_env.step(state, snap["action"].to(device), program.generator_like(
        snap["gen"], device), *args)
    out = snap["out"]
    if control:
        _, out = ref_env.step(bf16_state(state), snap["action"].to(device), program.generator_like(
            snap["gen"], device), *args)
        out = {"obs": out.obs, "reward": out.reward, "done": out.done, "stats": out.stats}
    return max(tree_gap(out["obs"], tr.obs), tree_gap(out["reward"], tr.reward),
               tree_gap(out["done"], tr.done), tree_gap(out["stats"], tr.stats))


def reset_gap(gen_state, first_obs, ref_env, tp_fn, device, control: bool = False) -> float:
    """The reference's reset from the program's generator state, observed,
    against the program's first observation (`control`: the reference's,
    observed from the state held in bfloat16)."""
    state = ref_env.reset(program.generator_like(gen_state, device))
    obs = _observe(ref_env, state, tp_fn)
    if control:
        first_obs = _observe(ref_env, bf16_state(state), tp_fn)
    return tree_gap(first_obs, obs)


def _observe(env, state, tp_fn):
    if getattr(env, "provides_tp", False):
        return env.observe_full(state, tp_fn)[0]
    return env.observe(state)


def tp_function(learner) -> Callable:
    """The env's TP net call (history [E, H, F] → [E, 3 * future]) on the
    reference's TP parameters."""

    def fn(history):
        with torch.no_grad():
            return learner.tp_predict(history)

    return fn


def stats_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The largest gap of an evaluation's stat means, each against its
    reference value (at least 1e-3)."""
    if set(prog) != set(ref):
        return math.inf
    gaps = [abs(prog[k] - ref[k]) / max(abs(ref[k]), 1e-3) for k in ref
            if not (math.isnan(prog[k]) and math.isnan(ref[k]))]
    return max(gaps, default=0.0)


def finite(values) -> bool:
    return all(math.isfinite(float(v)) for v in values)
