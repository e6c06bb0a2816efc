#!/usr/bin/env python3
"""Time the encoder forward kernel (`encoder_pair_forward`, one launch for
the actor and the critic; `encoder_forward`, the critic alone) on one GPU,
at the rollout's act (S = 12,288 rows) and at a PPO minibatch (S = 49,152).

    python3 scripts/time_torch_forward.py [--tree DIR]

`--tree DIR` times the package of another checkout (an earlier commit,
unpacked), with the same draws, so two trees can be compared in one call:
run it for each, in turns.  Prints the card's name and power limit, each
time (median of single calls by CUDA events, host work before the launch
included; and the kernel's device time by torch.profiler) and one JSON
line.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

GROUPS = ((1, 35), (3, 5), (2, 3))  # the main path's observation groups
RUNS = 20


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    args = ap.parse_args()
    sys.path.insert(0, args.tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("time_torch_forward: needs a CUDA card", file=sys.stderr)
        return 2
    from mupe_tpu_torch.ops import build
    from mupe_tpu_torch.ops import fused_encoder as fe

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    info = build.build()
    print(f"{card}; tree {args.tree}; built in {info['seconds']:.1f} s", flush=True)
    for line in info["log"].splitlines():
        if any(w in line for w in ("entry function", "registers", "spill", "rror")):
            print(f"  ptxas: {line.strip()}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1)

    def leaves(spec):
        return [(torch.randn(s, generator=gen) / math.sqrt(s[0]) if len(s) == 2
                 else 0.1 * torch.randn(s, generator=gen)).to(dev) for s in fe.leaf_shapes(spec)]

    spec_a = fe.EncoderSpec(groups=GROUPS, head_dim=4)
    spec_c = fe.EncoderSpec(groups=GROUPS, head_dim=1)
    la, lc = leaves(spec_a), leaves(spec_c)

    def timed(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(RUNS):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times)

    def device_ms(fn):
        """Mean device time of the kernels of one call, over `runs` calls
        back to back (torch.profiler), and their wall time each."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(RUNS):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / RUNS
        dev_us = sum(e.device_time_total for e in prof.key_averages() if e.device_time_total > 0
                     and "encoder_fwd" in e.key)
        return dev_us / 1e3 / RUNS, wall

    out = {"tree": args.tree, "card": card}
    for s in (12288, 49152):
        x = (2.0 * torch.randn((s, spec_a.obs_dim), generator=gen)).to(dev)
        pair = timed(lambda: fe.encoder_pair_forward(spec_a, spec_c, la, lc, x))
        one = timed(lambda: fe.encoder_forward(spec_c, lc, x))
        pair_dev, pair_wall = device_ms(lambda: fe.encoder_pair_forward(spec_a, spec_c, la, lc, x))
        out[f"pair_ms_{s}"], out[f"one_ms_{s}"] = pair, one
        out[f"pair_device_ms_{s}"], out[f"pair_back_to_back_ms_{s}"] = pair_dev, pair_wall
        print(f"  S={s}: encoder_pair_forward {pair:.4f} ms (device {pair_dev:.4f} ms; "
              f"{pair_wall:.4f} ms each back to back, traced), encoder_forward {one:.4f} ms",
              flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
