#!/usr/bin/env python3
"""How far the encoder backward and the in-kernel loss kernels stray from
their plain versions over many random draws, on one GPU.

    python3 scripts/torch_tolerance_survey.py [--seeds 12] [--loss-seeds 30]
        [--tree DIR] [--out FILE]

`chip_smoke.py` holds each kernel to its limit on one fixed draw; this
script shows how much room those limits leave.  For each seed (weights,
rows and cotangents drawn as chip_smoke.py draws them):

* the pair backward at S = 49,152 and 49,153: each gradient leaf's mean
  error (`BWD_KERNEL_TOL`'s measure) for the kernel and for the f32 control
  (the plain version without its bf16 rounding, which the limit must
  reject);
* the forward + loss kernels at S = 1, 7, 8, 15, 16, 17 and 49,152: the
  per-row outputs against `KERNEL_TOL` / `LOSS_STATS_TOL` (the 1e-4 mean
  limits), and the agrad kernel's head-bias gradient against the column sum
  of the plain dmu (and the fwdloss kernel's own dmu summed, for scale).

`--tree DIR` runs the package and chip_smoke.py of another checkout (an
earlier commit, unpacked), for the same draws.  `--out` writes every number
as JSON.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--loss-seeds", type=int, default=30)
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, args.tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_tolerance_survey: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mupe_tpu_torch.ops import fused_encoder as fe

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.card_line(), "package", fe.__file__, flush=True)
    spec_a = fe.EncoderSpec(groups=cs.GROUPS, head_dim=4)
    spec_c = fe.EncoderSpec(groups=cs.GROUPS, head_dim=1)
    tol = fe.BWD_KERNEL_TOL
    blind = {i % spec_a.n_leaves for i in fe.BWD_CONTROL_BLIND}
    noise = {i % spec_a.n_leaves for i in tol.noise_leaves}
    out = {"backward": [], "loss": []}

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return (gen, cs.random_leaves(fe.leaf_shapes(spec_a), gen, dev),
                cs.random_leaves(fe.leaf_shapes(spec_c), gen, dev))

    for seed in range(1, args.seeds + 1):
        gen, la, lc = draw(seed)
        for s in (49152, 49153):
            x = (2.0 * torch.randn((s, spec_a.obs_dim), generator=gen)).to(dev)
            da = torch.randn((s, 4), generator=gen).to(dev)
            dc = torch.randn((s, 1), generator=gen).to(dev)
            grads = fe.encoder_backward([(spec_a, la), (spec_c, lc)], x, [da, dc])
            for net, spec, leaves, d, g in (("actor", spec_a, la, da, grads[0]),
                                            ("critic", spec_c, lc, dc, grads[1])):
                ref = fe.reference_backward(spec, leaves, x, d)
                out["backward"].append(dict(
                    seed=seed, s=s, net=net, kernel=tol.errors(g, ref),
                    control=tol.errors(fe.reference_backward(spec, leaves, x, d, bf16=False), ref)))
    worst = collections.defaultdict(float)
    least = collections.defaultdict(lambda: float("inf"))
    over, passes = [], []
    for r in out["backward"]:
        for i, (k, c) in enumerate(zip(r["kernel"], r["control"])):
            if i in noise:
                continue
            key = (r["net"], i)
            worst[key] = max(worst[key], k["mean_rel"])
            if k["mean_rel"] > tol.mean_rel or k["max_rel"] > tol.max_rel:
                over.append((r["seed"], r["s"], r["net"], i, round(k["mean_rel"], 6)))
            if i not in blind:
                least[key] = min(least[key], c["mean_rel"])
                if c["mean_rel"] <= tol.mean_rel and c["max_rel"] <= tol.max_rel:
                    passes.append((r["seed"], r["s"], r["net"], i, round(c["mean_rel"], 6)))
    n = len(out["backward"])
    print(f"backward, {args.seeds} seeds x S = 49,152 / 49,153, per leaf: kernel's largest / "
          f"f32 control's least mean error")
    for net in ("actor", "critic"):
        print(f"  {net}: " + "  ".join(
            f"{i}:{worst[(net, i)]:.2e}/{least[(net, i)]:.2e}" for i in range(spec_a.n_leaves)
            if (net, i) in worst and i not in blind))
    print(f"  kernel past BWD_KERNEL_TOL in {len(over)} of {n} (seed, S, network) cases: {over}")
    print(f"  f32 control inside BWD_KERNEL_TOL on a leaf it must fail: {len(passes)} of "
          f"{n * (spec_a.n_leaves - len(blind))} (case, leaf) pairs: {passes}")

    small = (1, 7, 8, 15, 16, 17)
    for seed in range(1, args.loss_seeds + 1):
        gen, la, lc = draw(seed)
        for s in small + (49152,):
            x = (2.0 * torch.randn((s, spec_a.obs_dim), generator=gen)).to(dev)
            loss, rows = cs.loss_inputs(spec_a, spec_c, la, lc, x, gen)
            a = (spec_a, spec_c, loss, la, lc, *rows)
            out9, out10, ref = (fe.pair_forward_loss(*a), fe.pair_forward_loss_agrad(*a),
                                fe.reference_pair_fwd_loss(*a))
            rec = dict(seed=seed, s=s)
            for kernel, rows_out, stats in (("fwdloss", out9[1:3], out9[3]),
                                            ("agrad", out10[:2], out10[2])):
                errs = [fe.KERNEL_TOL.errors(o, r) for o, r in zip(rows_out, ref[1:3])]
                errs += [fe.LOSS_STATS_TOL.errors(stats[:, c], ref[3][:, c])
                         for c in range(ref[3].shape[1])]
                rec[kernel] = errs
            rec["bias_vs_plain"] = fe.KERNEL_TOL.errors(out10[3][-1], ref[0].sum(0))
            rec["fwdloss_dmu_sum_vs_plain"] = fe.KERNEL_TOL.errors(out9[0].sum(0), ref[0].sum(0))
            out["loss"].append(rec)
    print(f"forward + loss kernels, {args.loss_seeds} seeds: (cases past the 1e-4 mean or the "
          f"max limits, largest mean error, largest max error / its limit)")
    for kernel in ("fwdloss", "agrad"):
        for label, sel in (("S = 1-17", lambda r: r["s"] in small), ("S = 49,152",
                                                                    lambda r: r["s"] == 49152)):
            recs = [r for r in out["loss"] if sel(r)]
            limits = [fe.KERNEL_TOL.max_rel] * 2 + [fe.LOSS_STATS_TOL.max_rel] * (
                len(recs[0][kernel]) - 2)
            bad = sum(any(e["mean_rel"] > 1e-4 or e["max_rel"] > lim
                          for e, lim in zip(r[kernel], limits)) for r in recs)
            mean = max(e["mean_rel"] for r in recs for e in r[kernel])
            mx = max(e["max_rel"] / lim for r in recs for e, lim in zip(r[kernel], limits))
            print(f"  {kernel} {label}: {bad} of {len(recs)}, {mean:.3e}, {mx:.3f}")
    for key in ("bias_vs_plain", "fwdloss_dmu_sum_vs_plain"):
        print(f"  {key}: largest mean error " + ", ".join(
            f"S={s}: {max(r[key]['mean_rel'] for r in out['loss'] if r['s'] == s):.2e}"
            for s in small + (49152,)))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
