#!/usr/bin/env python3
"""How far the encoder kernels (forward, backward, in-kernel loss) and the
TP-LSTM kernels (forward, backward) stray from their plain versions over
many random draws, on one GPU.

    python3 scripts/torch_tolerance_survey.py [--seeds 12] [--loss-seeds 30]
        [--wide-seeds 4] [--limit-seeds 4] [--flips 2] [--tp-seeds 12]
        [--tp-wide-seeds 4] [--tp-limit-seeds 4] [--out FILE]

`chip_smoke.py` holds each kernel to its limit on one fixed draw; this
script shows how much room those limits leave.  Every limit with a
`floor_mult` is at least that multiple of its floor: the error of the f32
plain version against the plain version in f64 (`tolerance.in_f64`), what
f32 summation alone costs that output at that draw.  For each seed
(weights, rows and cotangents drawn as chip_smoke.py draws them):

* the pair backward at S = 49,152 and 49,153 of the main path's spec, at
  S = 49,152 of 8 tokens with a 50-wide group (`--wide-seeds`) and of 28
  tokens over 261 columns with a 140-wide group (`--limit-seeds`; the
  streamed instance): per gradient leaf the mean error of the kernel and
  of the f32 control (the plain version without its bf16 rounding, which
  the limit must reject), absolute and as a multiple of the floor, against
  `BWD_KERNEL_TOL`;
* the pair forward at S = 49,152 of the main spec and of the 28-token one:
  the kernel and the control against `KERNEL_TOL`; and of the 28-token spec
  at the 8-row tile's edges S = 1, 7, 8, 9, 17 (three draws a limit seed):
  the kernel against `KERNEL_TOL` and against the small-S per-row limits
  (`loss_row_tols`) that the streamed specs are held to there;
* with `--flips N`, for the first N seeds, where the kernel's stage A parts
  from the plain one: per staged bf16 operand the share of values that
  differ, and the mean error of each leaf's column sums;
* the forward + loss kernels at S = 1, 7, 8, 15, 16, 17 and 49,152: the
  per-row outputs and the stats (column by column) against `loss_row_tols`,
  and the agrad kernel's head-bias gradient against the column sum of the
  plain dmu (`DMU_SUM_TOL`; the fwdloss kernel's own dmu summed, for scale);
* the TP forward and backward at N = 241,664 and 241,665 windows of the
  main path's shape (16 inputs, 10 steps, 15 outputs; `--tp-seeds`) and at
  N = 241,664 of F 34, T 20, O 30 (`--tp-wide-seeds`) and at N = 98,304 of
  F 91, T 40, O 120 (`--tp-limit-seeds`, the generic instance): the forward
  against
  `tp_lstm.KERNEL_TOL`, the backward per gradient leaf against
  `tp_lstm.BWD_KERNEL_TOL`, each with its f32 control, absolute and as a
  multiple of the floor.

A count of 0 skips its part.  `--out` writes every number as JSON.  Needs
a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--loss-seeds", type=int, default=30)
    ap.add_argument("--wide-seeds", type=int, default=4)
    ap.add_argument("--limit-seeds", type=int, default=4)
    ap.add_argument("--flips", type=int, default=0)
    ap.add_argument("--tp-seeds", type=int, default=12)
    ap.add_argument("--tp-wide-seeds", type=int, default=4)
    ap.add_argument("--tp-limit-seeds", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_tolerance_survey: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mupe_tpu_torch.ops import fused_encoder as fe
    from mupe_tpu_torch.ops.tolerance import in_f64

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    tol = fe.BWD_KERNEL_TOL
    out = {"backward": [], "forward": [], "forward_small": [], "loss": [], "flips": [],
           "tp": []}
    groups_of = {"main": cs.GROUPS, "wide": cs.WIDE_GROUPS, "limit": cs.LIMIT_GROUPS}
    seed_base = {"main": 0, "wide": 1000, "limit": 2000}

    def draw(seed, groups):
        gen = torch.Generator().manual_seed(seed)
        spec_a = fe.EncoderSpec(groups=groups, head_dim=4)
        spec_c = fe.EncoderSpec(groups=groups, head_dim=1)
        return (gen, spec_a, spec_c, cs.random_leaves(fe.leaf_shapes(spec_a), gen, dev),
                cs.random_leaves(fe.leaf_shapes(spec_c), gen, dev))

    runs = [("main", seed, s) for seed in range(1, args.seeds + 1) for s in (49152, 49153)]
    runs += [("wide", seed, 49152) for seed in range(1, args.wide_seeds + 1)]
    runs += [("limit", seed, 49152) for seed in range(1, args.limit_seeds + 1)]
    for kind, seed, s in runs:
        gen, spec_a, spec_c, la, lc = draw(seed + seed_base[kind], groups_of[kind])
        x = (2.0 * torch.randn((s, spec_a.obs_dim), generator=gen)).to(dev)
        da = torch.randn((s, 4), generator=gen).to(dev)
        dc = torch.randn((s, 1), generator=gen).to(dev)
        grads = fe.encoder_backward([(spec_a, la), (spec_c, lc)], x, [da, dc])
        for net, spec, leaves, d, g in (("actor", spec_a, la, da, grads[0]),
                                        ("critic", spec_c, lc, dc, grads[1])):
            ref = fe.reference_backward(spec, leaves, x, d)
            ctl = fe.reference_backward(spec, leaves, x, d, bf16=False)
            exact = in_f64(fe.reference_backward, spec, leaves, x, d)
            out["backward"].append(dict(
                kind=kind, seed=seed, s=s, net=net, kernel=tol.errors(g, ref, exact),
                control=tol.errors(ctl, ref, exact),
                floor=[e["mean_rel"] for e in tol.errors(ref, exact)]))
        if kind != "wide" and s == 49152:
            for net, spec, leaves, o in zip(("actor", "critic"), (spec_a, spec_c), (la, lc),
                                            fe.encoder_pair_forward(spec_a, spec_c, la, lc, x)):
                ref = fe.reference_apply(spec, leaves, x)
                exact = in_f64(fe.reference_apply, spec, leaves, x)
                out["forward"].append(dict(
                    kind=kind, seed=seed, net=net, kernel=fe.KERNEL_TOL.errors(o, ref, exact),
                    control=fe.KERNEL_TOL.errors(fe.reference_apply(spec, leaves, x, bf16=False),
                                                 ref, exact),
                    floor=fe.KERNEL_TOL.errors(ref, exact)))
            if kind == "main" and seed <= args.flips:
                flats, stagings = fe._launch_operands(x, [(spec_a, la), (spec_c, lc)], [da, dc])
                for net, spec, leaves, d, flat, st in (
                        ("actor", spec_a, la, da, flats[0], stagings[0]),
                        ("critic", spec_c, lc, dc, flats[1], stagings[1])):
                    ref_st, ref_sums = fe.reference_backward_operands(spec, leaves, x, d)
                    views = fe.split_flat(spec, flat)
                    out["flips"].append(dict(
                        seed=seed, net=net,
                        staged={k: float((st[k][..., :s, :].float() != ref_st[k]).float().mean())
                                for k in fe._STAGED},
                        sums={i: fe.KERNEL_TOL.errors(views[i], v)["mean_rel"]
                              for i, v in ref_sums.items()}))

    for kind in ("main", "wide", "limit"):
        recs = [r for r in out["backward"] if r["kind"] == kind]
        if not recs:
            continue
        n_leaves = len(recs[0]["kernel"])
        blind = {i % n_leaves for i in fe.BWD_CONTROL_BLIND}
        noise = {i % n_leaves for i in tol.noise_leaves}
        worst = collections.defaultdict(lambda: (0.0, 0.0))
        least = collections.defaultdict(lambda: (float("inf"), float("inf")))
        over, passes = [], []
        for r in recs:
            bad, cbad = set(tol.failing(r["kernel"])), set(tol.failing(r["control"]))
            for i, (k, c, f) in enumerate(zip(r["kernel"], r["control"], r["floor"])):
                key = (r["net"], i)
                if i not in noise:
                    worst[key] = tuple(max(a, b) for a, b in zip(
                        worst[key], (k["mean_rel"], k["mean_rel"] / max(f, 1e-30))))
                if i in bad:
                    over.append((r["seed"], r["s"], r["net"], i, round(k["mean_rel"], 6)))
                if i not in blind:
                    least[key] = tuple(min(a, b) for a, b in zip(
                        least[key], (c["mean_rel"], c["mean_rel"] / max(f, 1e-30))))
                    if i not in cbad:
                        passes.append((r["seed"], r["s"], r["net"], i, round(c["mean_rel"], 6)))
        print(f"backward ({kind}, {groups_of[kind]}), {len(recs) // 2} (seed, S) draws; per leaf "
              f"the kernel's largest and the f32 control's least mean error, absolute and / the "
              f"floor (the limit: {tol.floor_mult:g} x the floor, at least {tol.mean_rel:g})")
        for net in ("actor", "critic"):
            print(f"  {net}: " + "  ".join(
                f"{i}:{worst[(net, i)][0]:.2e}({worst[(net, i)][1]:.2f}x)/"
                f"{least[(net, i)][0]:.2e}({least[(net, i)][1]:.1f}x)"
                for i in range(n_leaves) if i not in blind | noise))
        kmax = max(v[1] for (_, i), v in worst.items() if i not in blind)
        cmin = min(v[1] for v in least.values())
        print(f"  kernel past BWD_KERNEL_TOL in {len(over)} of {len(recs)} (seed, S, network) "
              f"cases: {over}")
        print(f"  f32 control inside BWD_KERNEL_TOL on a leaf it must fail: {len(passes)} of "
              f"{len(recs) * (n_leaves - len(blind))} (case, leaf) pairs: {passes}")
        print(f"  largest kernel / floor {kmax:.2f}, least control / floor {cmin:.2f}")

    for kind in ("main", "limit"):
        forward_summary(kind, [r for r in out["forward"] if r["kind"] == kind])
    forward_small(args, out, dev, draw)
    for rec in out["flips"]:
        print(f"stage A vs plain, seed {rec['seed']} {rec['net']}: share of staged values that "
              f"differ: " + ", ".join(f"{k} {v:.2e}" for k, v in rec["staged"].items())
              + "; column sums' mean error: "
              + ", ".join(f"{i}: {v:.1e}" for i, v in sorted(rec["sums"].items())))

    small = (1, 7, 8, 15, 16, 17)
    for seed in range(1, args.loss_seeds + 1):
        gen, spec_a, spec_c, la, lc = draw(seed, cs.GROUPS)
        for s in small + (49152,):
            x = (2.0 * torch.randn((s, spec_a.obs_dim), generator=gen)).to(dev)
            loss, rows = cs.loss_inputs(spec_a, spec_c, la, lc, x, gen)
            a = (spec_a, spec_c, loss, la, lc, *rows)
            out9, out10 = fe.pair_forward_loss(*a), fe.pair_forward_loss_agrad(*a)
            ref, exact = fe.reference_pair_fwd_loss(*a), in_f64(fe.reference_pair_fwd_loss, *a)
            rows_tol, stats_tol = fe.loss_row_tols(s)
            rec = dict(seed=seed, s=s)
            for kernel, rows_out, stats in (("fwdloss", out9[1:3], out9[3]),
                                            ("agrad", out10[:2], out10[2])):
                rec[kernel] = ([rows_tol.errors(o, r, e)
                                for o, r, e in zip(rows_out, ref[1:3], exact[1:3])]
                               + [stats_tol.errors(stats[:, c], ref[3][:, c], exact[3][:, c])
                                  for c in range(ref[3].shape[1])])
            if s == 49152:  # the f32 control, on every output but R and R²
                ctl = fe.reference_pair_fwd_loss(*a, bf16=False)
                rec["control"] = (
                    [fe.KERNEL_TOL.errors(c, r, e) for c, r, e in zip(ctl[:3], ref[:3], exact[:3])]
                    + [fe.LOSS_STATS_TOL.errors(ctl[3][:, c], ref[3][:, c], exact[3][:, c])
                       for c in range(ref[3].shape[1]) if c not in (fe._SUM_RET, fe._SUM_RET2)])
            rec["bias_vs_plain"] = fe.DMU_SUM_TOL.errors(out10[3][-1], ref[0].sum(0))
            rec["fwdloss_dmu_sum_vs_plain"] = fe.DMU_SUM_TOL.errors(out9[0].sum(0), ref[0].sum(0))
            out["loss"].append(rec)
    tp_survey(args, out, dev)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out))
    if not out["loss"]:
        return 0
    print(f"forward + loss kernels, {args.loss_seeds} seeds: (seed, S, outputs) past their "
          f"limits (`loss_row_tols`; dv1, dv2, then the stats columns), largest mean and max "
          f"error as a share of their limits")
    for kernel in ("fwdloss", "agrad"):
        for label, sel in (("S = 1-17", lambda r: r["s"] in small),
                           ("S = 49,152", lambda r: r["s"] == 49152)):
            recs = [r for r in out["loss"] if sel(r)]
            bad = [(r["seed"], r["s"], [c for c, e in enumerate(r[kernel])
                                        if not fe.KERNEL_TOL.holds(e)]) for r in recs]
            bad = [b for b in bad if b[2]]
            mean = max(e["mean_rel"] / e["mean_limit"] for r in recs for e in r[kernel])
            mx = max(e["max_rel"] / e["max_limit"] for r in recs for e in r[kernel])
            print(f"  {kernel} {label}: {len(bad)} of {len(recs)} {bad}, {mean:.3f}, {mx:.3f}")
    ctl = [r for r in out["loss"] if "control" in r]
    cpass = [(r["seed"], c) for r in ctl for c, e in enumerate(r["control"])
             if fe.KERNEL_TOL.holds(e)]
    print(f"  f32 control of the forward + loss at S = 49,152 (dmu, dv1, dv2, the stats but R, "
          f"R²) inside its limits: {len(cpass)} of {sum(len(r['control']) for r in ctl)} "
          f"{cpass}; least mean error / its limit "
          f"{min(e['mean_rel'] / e['mean_limit'] for r in ctl for e in r['control']):.2f}")
    dmu_bad = [(r["seed"], r["s"]) for r in out["loss"]
               if not fe.DMU_SUM_TOL.holds(r["bias_vs_plain"])]
    print(f"  agrad head-bias gradient past DMU_SUM_TOL: {len(dmu_bad)} of {len(out['loss'])} "
          f"{dmu_bad}")
    for key in ("bias_vs_plain", "fwdloss_dmu_sum_vs_plain"):
        print(f"  {key}: largest mean error " + ", ".join(
            f"S={s}: {max(r[key]['mean_rel'] for r in out['loss'] if r['s'] == s):.2e}"
            for s in small + (49152,)))
    return 0


def forward_summary(kind, f) -> None:
    """The pair forward at S = 49,152 of one spec: the kernel's and the f32
    control's errors against KERNEL_TOL."""
    from mupe_tpu_torch.ops import fused_encoder as fe

    if not f:
        return
    bad = [(r["seed"], r["net"]) for r in f if not fe.KERNEL_TOL.holds(r["kernel"])]
    cpass = [(r["seed"], r["net"]) for r in f if fe.KERNEL_TOL.holds(r["control"])]
    print(f"forward ({kind}) S = 49,152, {len(f)} (seed, network) draws: kernel largest max / "
          f"mean error {max(r['kernel']['max_rel'] for r in f):.3e} / "
          f"{max(r['kernel']['mean_rel'] for r in f):.3e}, as a share of their limits "
          f"{max(r['kernel']['max_rel'] / r['kernel']['max_limit'] for r in f):.3f} / "
          f"{max(r['kernel']['mean_rel'] / r['kernel']['mean_limit'] for r in f):.3f}; floor's "
          f"largest max / mean {max(r['floor']['max_rel'] for r in f):.3e} / "
          f"{max(r['floor']['mean_rel'] for r in f):.3e}; control least mean "
          f"{min(r['control']['mean_rel'] for r in f):.3e} "
          f"({min(r['control']['mean_rel'] / r['control']['mean_limit'] for r in f):.1f}x its "
          f"limit); kernel past KERNEL_TOL: {bad}; control inside it: {cpass}")


def forward_small(args, out, dev, draw) -> None:
    """The streamed pair forward (28 tokens) at the 8-row tile's edges, three
    draws a limit seed: how often one row's flip cascade takes the mean error
    past KERNEL_TOL, and whether the small-S per-row limits hold."""
    import torch

    import chip_smoke as cs
    from mupe_tpu_torch.ops import fused_encoder as fe
    from mupe_tpu_torch.ops.tolerance import in_f64

    for seed in range(1, 3 * args.limit_seeds + 1):
        gen, spec_a, spec_c, la, lc = draw(seed + 3000, cs.LIMIT_GROUPS)
        for s in cs.TILE_EDGE_ROWS:
            x = (2.0 * torch.randn((s, spec_a.obs_dim), generator=gen)).to(dev)
            for net, spec, leaves, o in zip(("actor", "critic"), (spec_a, spec_c), (la, lc),
                                            fe.encoder_pair_forward(spec_a, spec_c, la, lc, x)):
                ref = fe.reference_apply(spec, leaves, x)
                exact = in_f64(fe.reference_apply, spec, leaves, x)
                out["forward_small"].append(dict(
                    seed=seed, s=s, net=net, kernel=fe.KERNEL_TOL.errors(o, ref, exact),
                    small=fe.loss_row_tols(s)[0].errors(o, ref, exact)))
    f = out["forward_small"]
    if not f:
        return
    bad = [(r["seed"], r["s"], r["net"], round(r["kernel"]["mean_rel"], 6)) for r in f
           if not fe.KERNEL_TOL.holds(r["kernel"])]
    small_tol = fe.loss_row_tols(1)[0]
    sbad = [(r["seed"], r["s"], r["net"]) for r in f if not small_tol.holds(r["small"])]
    print(f"forward (limit) S = {cs.TILE_EDGE_ROWS}, {len(f)} (seed, S, network) draws: kernel "
          f"largest max / mean error {max(r['kernel']['max_rel'] for r in f):.3e} / "
          f"{max(r['kernel']['mean_rel'] for r in f):.3e}; past KERNEL_TOL {len(bad)} {bad}; "
          f"largest mean / the small-S per-row limit "
          f"{max(r['small']['mean_rel'] / r['small']['mean_limit'] for r in f):.3f}, max "
          f"{max(r['small']['max_rel'] / r['small']['max_limit'] for r in f):.3f}; past it "
          f"{len(sbad)} {sbad}")


def tp_survey(args, out, dev) -> None:
    """The TP-LSTM kernels over `--tp-seeds` draws of the main shape (N =
    241,664 and 241,665) and `--tp-wide-seeds` of the wide one (N =
    241,664), printed per leaf as the backward's table; records in out["tp"]."""
    import torch

    import chip_smoke as cs
    from mupe_tpu_torch.ops import tp_lstm as tl
    from mupe_tpu_torch.ops.tolerance import in_f64

    shapes = {"main": (16, 10, 15), "wide": cs.WIDE_TP, "limit": cs.LIMIT_TP}
    runs = [("main", seed, n) for seed in range(1, args.tp_seeds + 1)
            for n in (cs.TP_WINDOWS, cs.TP_WINDOWS + 1)]
    runs += [("wide", seed, cs.TP_WINDOWS) for seed in range(1, args.tp_wide_seeds + 1)]
    runs += [("limit", seed, cs.LIMIT_TP_WINDOWS) for seed in range(1, args.tp_limit_seeds + 1)]
    seed_base = {"main": 0, "wide": 1000, "limit": 2000}
    ftol, btol = tl.KERNEL_TOL, tl.BWD_KERNEL_TOL
    for kind, seed, n in runs:
        f, t, o = shapes[kind]
        spec = tl.TPLSTMSpec(input_dim=f, hidden=64, t_steps=t, out_dim=o)
        gen = torch.Generator().manual_seed(seed + seed_base[kind])
        lt = cs.random_leaves(spec.leaf_shapes(), gen, dev)
        x = torch.randn((n, t, f), generator=gen).to(dev)
        dy = torch.randn((n, o), generator=gen).to(dev)
        y = tl.tp_forward(spec, lt, x)
        ref, exact = tl.reference_forward(spec, lt, x), in_f64(tl.reference_forward, spec, lt, x)
        rec = dict(kind=kind, seed=seed, n=n, fwd=ftol.errors(y, ref, exact),
                   fwd_control=ftol.errors(tl.reference_forward(spec, lt, x, bf16=False), ref,
                                           exact),
                   fwd_floor=ftol.errors(ref, exact))
        g = tl.tp_backward(spec, lt, x, dy)
        ref = tl.reference_backward(spec, lt, x, dy)
        exact = in_f64(tl.reference_backward, spec, lt, x, dy)
        rec.update(bwd=btol.errors(g, ref, exact),
                   bwd_control=btol.errors(tl.reference_backward(spec, lt, x, dy, bf16=False),
                                           ref, exact),
                   bwd_floor=[e["mean_rel"] for e in btol.errors(ref, exact)])
        out["tp"].append(rec)
        del x, dy, g, ref, exact
    blind = {i % 5 for i in tl.BWD_CONTROL_BLIND}
    names = ("wi", "wh", "b", "wfc", "bfc")
    for kind in ("main", "wide", "limit"):
        recs = [r for r in out["tp"] if r["kind"] == kind]
        if not recs:
            continue
        print(f"TP ({kind}: F, T, O = {shapes[kind]}), {len(recs)} (seed, N) draws")
        fbad = [(r["seed"], r["n"]) for r in recs if not ftol.holds(r["fwd"])]
        fpass = [(r["seed"], r["n"]) for r in recs if ftol.holds(r["fwd_control"])]
        print(f"  forward: kernel largest max / mean error "
              f"{max(r['fwd']['max_rel'] for r in recs):.3e} / "
              f"{max(r['fwd']['mean_rel'] for r in recs):.3e}, as a share of their limits "
              f"{max(r['fwd']['max_rel'] / r['fwd']['max_limit'] for r in recs):.3f} / "
              f"{max(r['fwd']['mean_rel'] / r['fwd']['mean_limit'] for r in recs):.3f}; "
              f"mean / floor {max(r['fwd']['mean_rel'] / max(r['fwd_floor']['mean_rel'], 1e-30) for r in recs):.2f}x; "
              f"control least mean {min(r['fwd_control']['mean_rel'] for r in recs):.3e} "
              f"({min(r['fwd_control']['mean_rel'] / r['fwd_control']['mean_limit'] for r in recs):.1f}x "
              f"its limit); kernel past KERNEL_TOL: {fbad}; control inside it: {fpass}")
        worst = [max((r["bwd"][i]["mean_rel"], r["bwd"][i]["mean_rel"] / max(r["bwd_floor"][i], 1e-30))
                     for r in recs) for i in range(5)]
        least = [min((r["bwd_control"][i]["mean_rel"],
                      r["bwd_control"][i]["mean_rel"] / max(r["bwd_floor"][i], 1e-30))
                     for r in recs) for i in range(5)]
        kmax = [max(r["bwd"][i]["max_rel"] for r in recs) for i in range(5)]
        over = [(r["seed"], r["n"], btol.failing(r["bwd"])) for r in recs if btol.failing(r["bwd"])]
        passes = [(r["seed"], r["n"], i) for r in recs for i in range(5)
                  if i not in blind and i not in btol.failing(r["bwd_control"])]
        print("  backward per leaf: kernel largest mean error (x floor), largest max error; "
              "f32 control least mean error (x floor): " + "  ".join(
                  f"{names[i]}: {worst[i][0]:.2e}({worst[i][1]:.2f}x), {kmax[i]:.2e}; "
                  f"{least[i][0]:.2e}({least[i][1]:.1f}x)" for i in range(5)))
        print(f"  kernel past BWD_KERNEL_TOL: {len(over)} of {len(recs)} {over}; f32 control "
              f"inside it on a leaf it must fail: {len(passes)} of {len(recs) * (5 - len(blind))} "
              f"{passes}")


if __name__ == "__main__":
    sys.exit(main())
