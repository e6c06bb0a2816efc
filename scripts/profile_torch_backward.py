#!/usr/bin/env python3
"""Device time of each kernel of the encoder backward, of the agrad kernel's
call, of the fwdloss kernel's (kernel 9) and of the pair forward's, at the
update's minibatch (S = 49,152 rows), on one GPU.

    python3 scripts/profile_torch_backward.py [--calls 10] [--tree DIR]
        [--spec main|tok16|tok17|limit]

`--spec` takes chip_smoke.py's observation groups: the main path's (the
default), 16 tokens over 148 columns, 17 tokens, or 28 tokens over 261
columns with a 140-wide group (the last two the streamed instances).

`chip_smoke.py` times a call from its first event to its last, host work
before the first launch included.  Here `torch.profiler` gives the device
time of each kernel over `--calls` calls (stage A, stage B, the fixed-order
sums, the bf16 weight copies), and CUDA events the time of 20 calls issued
back to back, where the host's work overlaps the card's.  `--tree DIR`
profiles the package of another checkout (an earlier commit, unpacked), so
two trees can be compared in one call: run it for each, in turns.  Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path



def device_us(ev) -> float:
    """A profiler row's device time (its name differs across versions)."""
    return getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--spec", default="main", choices=("main", "tok16", "tok17", "limit"))
    args = ap.parse_args()
    sys.path.insert(0, args.tree)
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_backward: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mupe_tpu_torch.ops import fused_encoder as fe

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"{cs.card_line()}; tree {args.tree}", flush=True)
    gen = torch.Generator().manual_seed(1)
    groups = getattr(cs, {"main": "GROUPS", "tok16": "TOK16_GROUPS", "tok17": "TOK17_GROUPS",
                          "limit": "LIMIT_GROUPS"}[args.spec])
    print(f"groups {groups}", flush=True)
    spec_a = fe.EncoderSpec(groups=groups, head_dim=4)
    spec_c = fe.EncoderSpec(groups=groups, head_dim=1)
    la = cs.random_leaves(fe.leaf_shapes(spec_a), gen, dev)
    lc = cs.random_leaves(fe.leaf_shapes(spec_c), gen, dev)
    s = cs.MB_ROWS
    x = (2.0 * torch.randn((s, spec_a.obs_dim), generator=gen)).to(dev)
    da = torch.randn((s, 4), generator=gen).to(dev)
    dc = torch.randn((s, 1), generator=gen).to(dev)
    pair = [(spec_a, la), (spec_c, lc)]
    loss, rows = cs.loss_inputs(spec_a, spec_c, la, lc, x, gen)
    largs = (spec_a, spec_c, loss, la, lc, *rows)
    calls = {"pair backward": lambda: fe.encoder_backward(pair, x, [da, dc]),
             "one-network backward (actor)": lambda: fe.encoder_backward([(spec_a, la)], x, [da]),
             "agrad (kernel 10)": lambda: fe.pair_forward_loss_agrad(*largs),
             "fwdloss (kernel 9)": lambda: fe.pair_forward_loss(*largs),
             "pair forward": lambda: fe.encoder_pair_forward(spec_a, spec_c, la, lc, x)}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.calls):
                fn()
            torch.cuda.synchronize()
        print(f"== {name} at S = {s}: device time a call, by kernel")
        total = 0.0
        for ev in sorted(prof.key_averages(), key=lambda e: -device_us(e)):
            if (device_us(ev) <= 0 or ev.key.startswith(("aten::", "cuda", "Activity"))
                    or "(" not in ev.key):  # autograd functions' rows repeat their kernels'
                continue
            ms = device_us(ev) / 1e3 / args.calls
            total += ms
            print(f"  {ms:9.4f} ms  {ev.count // args.calls:3d} launches  {ev.key[:90]}")
        print(f"  {total:9.4f} ms  in all")
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        stop.record()
        torch.cuda.synchronize()
        print(f"  {start.elapsed_time(stop) / 20:9.4f} ms  a call, 20 calls back to back")
    return 0


if __name__ == "__main__":
    sys.exit(main())
