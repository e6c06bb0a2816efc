"""Evaluate a checkpoint on every fixed scenario on the card (counterpart of
scripts/eval_sweep.py; the reference protocol, README.md:147-149).

Usage: python -m mupe_tpu_torch.eval_sweep model_dir=runs/<name>/checkpoints \
    [env.num_envs=N] [out=results.json]

One `evaluate` for each of `EVAL_SCENARIOS`, with `use_random_cylinder=false`,
`use_eval=true` and `max_cylinders=6` (the passage and random layouts place 6
cylinders; the observation's nearest cylinders and the TP input without
obstacles do not change, so trained checkpoints fit).  Prints, and writes to
`out=` when given, one JSON object of the headline results by scenario.
"""
from __future__ import annotations

import json
import sys
from typing import Dict, Sequence

import torch

from .envs.scenarios import EVAL_SCENARIOS
from .harness import evaluate

RESULT_KEYS = ("success", "first_capture_step", "first_capture_step_p25",
               "first_capture_step_p50", "first_capture_step_p75", "episodes", "collision",
               "target_predicted_error", "detect_reward")


def sweep(argv: Sequence[str], device: torch.device | str = "cuda") -> Dict[str, Dict[str, float]]:
    """{scenario: {result key: value}}; `out=PATH` also writes the JSON."""
    base = [a for a in argv if not a.startswith(("env.scenario_flag", "out="))]
    out_path = next((a.split("=", 1)[1] for a in argv if a.startswith("out=")), None)
    results = {}
    for flag in EVAL_SCENARIOS:
        print(f"--- scenario: {flag}")
        res = evaluate(base + [f"env.scenario_flag={flag}", "env.use_random_cylinder=false",
                               "env.use_eval=true", "env.max_cylinders=6"], device=device)
        results[flag] = {k: res[k] for k in RESULT_KEYS if k in res}
    print(json.dumps(results, indent=2))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    sweep(sys.argv[1:])
