#!/usr/bin/env python3
"""Time the TP-LSTM kernels (`tp_forward`, `tp_backward`) on one GPU: the
forward at the rollout's act (N = 4,096 windows) and at the update's TP
step (N = 241,664), the backward at 241,664, at the main shape (16 inputs,
10 steps, 15 outputs) and the backward at 34 inputs, 20 steps, 30 outputs.

    python3 scripts/time_torch_tp.py [--tree DIR]

`--tree DIR` times the package of another checkout (an earlier commit,
unpacked), with the same draws, so two trees can be compared in one call:
run it for each, in turns.  Prints the card's name and power limit, each
time (median of single calls by CUDA events, host work before the first
launch included; and the device time of the call's kernels by
torch.profiler, by kernel) and one JSON line.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPES = {"main": (16, 10, 15), "wide": (34, 20, 30)}  # inputs, steps, outputs
N_ACT, N_UPDATE = 4096, 241664


def device_us(ev) -> float:
    """A profiler row's device time (its name differs across versions)."""
    return getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    args = ap.parse_args()
    sys.path.insert(0, args.tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("time_torch_tp: needs a CUDA card", file=sys.stderr)
        return 2
    from mupe_tpu_torch.ops import build
    from mupe_tpu_torch.ops import tp_lstm as tl

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    info = build.build()
    print(f"{card}; tree {args.tree}; built in {info['seconds']:.1f} s", flush=True)
    dev = torch.device("cuda", 0)

    def leaves(spec, gen):
        return [(torch.randn(s, generator=gen) / s[0] ** 0.5 if len(s) == 2
                 else 0.1 * torch.randn(s, generator=gen)).to(dev) for s in spec.leaf_shapes()]

    def events_ms(fn, runs):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times)

    def device_ms(fn, calls):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = {ev.key: device_us(ev) / 1e3 / calls for ev in prof.key_averages()
                if device_us(ev) > 0 and not ev.key.startswith(("aten::", "cuda", "Activity"))}
        return sum(rows.values()), rows

    out = {"card": card, "tree": args.tree}
    for shape, (f, t, o) in SHAPES.items():
        spec = tl.TPLSTMSpec(input_dim=f, hidden=64, t_steps=t, out_dim=o)
        gen = torch.Generator().manual_seed(11)
        lt = leaves(spec, gen)
        x = torch.randn((N_UPDATE, t, f), generator=gen).to(dev)
        dy = torch.randn((N_UPDATE, o), generator=gen).to(dev)
        calls = {"backward": (lambda: tl.tp_backward(spec, lt, x, dy), 5, 3)}
        if shape == "main":
            xa = x[:N_ACT].contiguous()
            calls = {"forward N=4096": (lambda: tl.tp_forward(spec, lt, xa), 20, 20),
                     "forward N=241664": (lambda: tl.tp_forward(spec, lt, x), 10, 5), **calls}
        for name, (fn, runs, prof_calls) in calls.items():
            ms = events_ms(fn, runs)
            dev_ms, rows = device_ms(fn, prof_calls)
            key = f"{shape} {name}"
            out[key] = {"ms": ms, "device_ms": dev_ms, "kernels": rows}
            print(f"{key}: {ms:.4f} ms a call (events), device {dev_ms:.4f} ms", flush=True)
            for k, v in sorted(rows.items(), key=lambda kv: -kv[1]):
                print(f"    {v:9.4f} ms  {k[:100]}")
        del x, dy
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
