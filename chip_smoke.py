#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port's main path (one GPU).

    python3 chip_smoke.py

Phases, each of which raises on failure (so any failure exits non-zero):

0. require a CUDA card; print its name and power limit (nvidia-smi);
1. build the CUDA kernels from mupe_tpu_torch/csrc/ with nvcc (timed);
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, and time both with CUDA events;
3. the slice: HideAndSeek (4096 arenas, 3 pursuers, random cylinders, TP
   net) with MAPPO acting, 2 warm-up + 3 timed rollouts of 64 steps, then
   the bootstrap value; checks launch counts, finiteness, the episode-stat
   keys and agreement with the CPU path on a small input; and a short
   rollout with 8-step episodes so auto-reset and scene sampling run;
4. training: `make_train_iter` (rollout + the MAPPO and TP-net update) at
   bench.py's configuration, 2 warm-up + 3 timed iterations; prints training
   env-steps/s and where an iteration's time goes, checks launch counts,
   the metrics' keys and finiteness, and the update on the card against the
   update on the CPU from the same state and trajectory;
5. AEG training: `harness.train` with task HideAndSeek_envgen (4096 arenas,
   a 5000-task buffer, TP net), 2 warm-up + 3 timed iterations; prints AEG
   training env-steps/s, checks that closed cycles took the FPS kernel, the
   buffer, the AEG stats, the update, `update_history` on the card against
   the CPU, and a checkpoint written and read back;
6. in-kernel-loss training: phase 4's configuration with
   `use_inkernel_loss=True`, once with `direct_mode="fwdloss"` and once with
   "agrad", 2 warm-up + 3 timed iterations each (and one with its phases
   synchronised); prints training env-steps/s per mode beside phase 4's and
   where an iteration's time goes, checks each mode's launch counts
   (64 loss-kernel launches an iteration, no pair forward from the update),
   the metrics and the update on the card against the CPU;
7. wide-configuration training: HideAndSeek with 4 pursuers, 4 cylinder
   tokens, 10 predicted steps and the obstacles in the TP input (8 tokens,
   `state_self` 50 wide, TP input 34, TP output 30), at 1024 arenas, 2
   iterations with the default update and 2 with `direct_mode="agrad"`;
   checks the launch counts, the outputs' finiteness and the update on the
   card against the CPU;
8. 16-token training: HideAndSeek with 6 pursuers, 10 cylinder tokens and
   21 predicted steps (16 tokens over 148 columns, `state_self` 83 wide, TP
   output 63), at 1024 arenas, 2 iterations each with the default update,
   `direct_mode="fwdloss"` and `direct_mode="agrad"`; the same checks;
9. past every limit the tile instances had: HideAndSeek with 8 pursuers,
   20 cylinders (all observed), 40 predicted steps, a 40-step history and
   the obstacles in the TP input (28 tokens over 261 columns, `state_self`
   140 wide; TP input 91, 40 steps, output 120): the encoder kernels'
   streamed instance and the TP kernels' generic one, at 1024 arenas, 2
   iterations in each of the three update modes; the same checks.

Phase 2 also holds the FPS kernel (the AEG buffer's downsampling, one
thread-block cluster) index for index against its plain version at the AEG's
pool, N = 9,096 tasks of D = 27, K = 5,000, at N = 9,097, at the cluster's
block-split edges there, at phase 9's task width (D = 87), with
duplicate rows in different blocks, with fewer valid points than K, past
the resident capacity (N = 49,153, the streamed instance) and at its largest
N (2^20), and times it at the AEG's pool and at N = 49,153; and the in-kernel
loss kernels (`pair_forward_loss`, `pair_forward_loss_agrad`)
at the update's minibatch, S = 49,152 and 49,153 rows, with a third of the
rows saturated in one case, and at the backward tile's edges; the agrad
kernel's gradients must be the same bits on a repeat launch and its
head-bias gradient the column sum of the plain version's dmu; the fwdloss
kernel's dv1, dv2 and stats must be the agrad kernel's bits, and its value
the pair forward's (both run the same tensor-core forward).  The encoder
backward and the agrad kernel run in two stages (A: the tile kernel, which
stages the bf16 operands of the weight products; B: `weight_grads`, those
products as a split-K GEMM): phase 2 holds each stage against its own plain
version (`reference_backward_operands` / `reference_agrad_operands`, and
`reference_weight_grads`) at S = 1, 7, 8, 15, 16, 17, 49,152 and 49,153,
and times each; and every encoder kernel at 7 tokens, at 8 tokens with a
50-wide group (the 8-row tile of stage A and of the agrad kernel, at its
edges S = 1, 7, 8, 9, 17), at 12 tokens and at 16 tokens over 148 columns
(the 16-token instances), at 17 tokens and at 28 tokens over 261 columns
with a 140-wide group (phase 9's; the streamed instances, the f32 control
rejected at S = 49,152), and the forward at a PPO minibatch (S = 49,152) as
well as at the act (S = 12,288).  The TP forward and backward are held at
the main shape and at 34 inputs, 20 steps and 30 outputs, at N = 1, 15, 16,
17 (the warp tile's edges), 4,096, 4,097, 241,664 and 241,665 windows, and
at phase 9's 91 inputs, 40 steps and 120 outputs (the generic instance) at
N = 1, 15, 16, 17 and its update's 98,304 windows, with
limits of at least 5x the f32 plain version's error against it in f64;
windows past N must add exact zeros; the forward is timed at the rollout's
N = 4,096 and the update's 241,664, the backward stage by stage, beside
`torch.nn.LSTM` (cuDNN; the recurrence alone) as a yardstick.
Each kernel's bound is the larger of its operations over the H100's peak
for their operand type (bf16 products summed in f32 for the encoder and
TP-LSTM kernels, which the tensor cores do at the bf16 rate; f32 for FPS)
and its bytes (each input read once, each output written once) over the
memory rate.  The line before the
last is the kernels' JSON summary (launches counted over phase 4's run, FPS
over phase 5's, the loss kernels over phase 6's run of their mode); the last
line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import csv
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

# outside a checkout of the repo this fails here, before any output
from mupe_tpu_torch.ops.tolerance import in_f64

NUM_ENVS = 4096
STEPS = 64
WARMUP_ROLLOUTS = 2
TIMED_ROLLOUTS = 3
TIMING_RUNS = 20
WARMUP_ITERS = 2
TIMED_ITERS = 3
MB_ROWS = NUM_ENVS * STEPS // 16 * 3  # one PPO minibatch's encoder rows (16 minibatches)
TP_WINDOWS = (STEPS - 5) * NUM_ENVS   # the TP step's windows (5 future steps)
GROUPS = ((1, 35), (3, 5), (2, 3))  # state_self, cylinders, state_others
# phase 7's configuration: 4 pursuers, 4 cylinder tokens, 10 predicted steps,
# obstacles in the TP input; its groups, and those of 4 pursuers alone
WIDE_ENV = dict(num_agents=4, obs_max_cylinder=4, future_prediction_step=10,
                use_obstacles_tp=True)
WIDE_GROUPS = ((1, 50), (4, 5), (3, 3))  # 8 tokens, state_self 50 wide
TOK7_GROUPS = ((1, 35), (3, 5), (3, 3))  # 7 tokens
TOK12_GROUPS = ((1, 50), (8, 5), (3, 3))   # 12 tokens (4 pursuers, 8 cylinder tokens)
TOK16_GROUPS = ((1, 83), (10, 5), (5, 3))  # 16 tokens over 148 columns (phase 8's)
WIDE_TP = (34, 20, 30)                   # TP inputs, steps, outputs
WIDE_NUM_ENVS = 1024
TILE_EDGE_ROWS = (1, 7, 8, 9, 17)        # the 8-row tile's edges
TOK17_GROUPS = ((1, 35), (11, 5), (5, 3))  # num_agents=6, obs_max_cylinder=11
# phase 9's configuration: past every limit of the tile instances
LIMIT_ENV = dict(num_agents=8, max_cylinders=20, obs_max_cylinder=20, future_prediction_step=40,
                 history_step=40, use_obstacles_tp=True)
LIMIT_GROUPS = ((1, 140), (20, 5), (7, 3))  # 28 tokens over 261 columns, state_self 140 wide
LIMIT_TP = (91, 40, 120)                    # TP inputs, steps, outputs
LIMIT_TP_WINDOWS = (STEPS - 40) * NUM_ENVS  # the update's windows at 40 predicted steps
TP_EDGE_WINDOWS = (1, 15, 16, 17)        # the TP warp tile's edges (16 windows)
# phase 8's configuration: 6 pursuers, 10 cylinder tokens, 21 predicted steps
# (16 tokens, state_self 83 wide, 148 observation columns, TP output 63)
TOK16_ENV = dict(num_agents=6, obs_max_cylinder=10, future_prediction_step=21)
METRIC_KEYS = {"advantages_mean", "advantages_std", "TP_loss", "policy_loss",
               "actor_grad_norm", "entropy", "ESS", "value_loss", "critic_grad_norm",
               "explained_var", "approx_kl", "action_norm", "value_running_mean"}
AEG_BUFFER = 5000                  # HideAndSeekEnvgenCfg.buffer_length
FPS_N, FPS_D = AEG_BUFFER + NUM_ENVS, 27  # the FPS pool: buffer + eval tasks, task_dim
FPS_D_LIMIT = 3 * 8 + 3 + 3 * 20   # phase 9's AEG task width (8 pursuers, 20 cylinders)
FPS_STREAMED_N = 49_153            # past the resident instance's capacity at D = 27
AEG_EPISODE = 16                   # cut from 800 so a 3-episode cycle closes in an iteration
# H100 SXM dense peaks (NVIDIA's data sheet): bf16 tensor cores, f32 outside
# the tensor cores, memory rate
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, runs: int = TIMING_RUNS, warmup: int = 3) -> float:
    """Median of `runs` CUDA-event timings of fn() after a warm-up."""
    for _ in range(warmup):
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, moved: float, peak: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take: the larger of the operations
    over the peak for their type and the bytes over the memory rate."""
    t_ops, t_mem = flops / peak, moved / PEAK_BYTES_PER_S
    return dict(bound_ms=max(t_ops, t_mem) * 1e3,
                bound_by="operations" if t_ops >= t_mem else "bytes")


def encoder_flops(spec, rows: int) -> int:
    """Multiply-adds (x2) of the products of one network's forward: embeds,
    q (token 0), k and v (every token), scores and the weighted sum, the out
    projection, the FFN and the head.  Elementwise work is not counted."""
    e, f, t = spec.embed_dim, spec.ff_dim, spec.n_tokens
    per_row = (spec.obs_dim * e + e * e + 2 * t * e * e + 2 * t * e + e * e + 2 * e * f
               + e * spec.head_dim)
    return 2 * rows * per_row


def encoder_bwd_flops(spec, rows: int) -> int:
    """Recomputed forward + two products per forward product (weights and
    inputs), less the input gradient of the embeds (x gets none)."""
    return 3 * encoder_flops(spec, rows) - 2 * rows * spec.obs_dim * spec.embed_dim


def tp_flops(spec, n: int) -> int:
    t, f, h, o = spec.t_steps, spec.input_dim, spec.hidden, spec.out_dim
    return 2 * n * (t * 4 * h * (f + h) + h * o)


def tp_bwd_flops(spec, n: int) -> int:
    """Recomputed forward, the head's two products, and per step the
    gradients of wi and wh and the carried dh."""
    t, f, h, o = spec.t_steps, spec.input_dim, spec.hidden, spec.out_dim
    return tp_flops(spec, n) + 2 * n * (2 * h * o + t * 4 * h * (f + 2 * h))


def random_leaves(shapes, gen, device):
    """Unit-scale weights (std 1/sqrt(fan_in)) and small nonzero biases, so
    every layer's output is O(1) and an error is visible in the result."""
    leaves = []
    for shape in shapes:
        if len(shape) == 2:
            w = torch.randn(shape, generator=gen) / math.sqrt(shape[0])
        else:
            w = 0.1 * torch.randn(shape, generator=gen)
        leaves.append(w.to(device).contiguous())
    return leaves


def compare(name, out, ref, tol, exact=None) -> float:
    """Kernel output against its plain version (`exact`: the plain version in
    f64, which sets the floor of a `floor_mult` limit); returns the max abs
    error."""
    errs = tol.errors(out, ref, exact)
    ok = tol.holds(errs) and bool(torch.isfinite(out).all())
    log(f"  {name}: max_abs_err={errs['max_abs']:.3e} max_rel_err={errs['max_rel']:.3e} "
        f"mean_rel_err={errs['mean_rel']:.3e} (limits {errs['max_limit']:.3g} max, "
        f"{errs['mean_limit']:.3g} mean) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return errs["max_abs"]


def control(name, plain, tol, exact=None) -> None:
    """The plain version without its bf16 rounding must fail the tolerance
    that the kernel passes; else the tolerance could not see a kernel that
    skips a rounding point."""
    errs = tol.errors(plain(bf16=False), plain(), exact)
    rejected = not tol.holds(errs)
    log(f"  control {name} in f32 throughout: max_rel_err={errs['max_rel']:.3e} "
        f"mean_rel_err={errs['mean_rel']:.3e} (limits {errs['max_limit']:.3g} max, "
        f"{errs['mean_limit']:.3g} mean) -> {'rejected' if rejected else 'PASSED'}")
    if not rejected:
        raise AssertionError(f"{name}: the tolerance does not reject the f32 control")


def bwd_compare(name, outs, refs, tol, exact=None) -> float:
    """A backward kernel's gradients against its plain version, leaf by
    leaf (`exact`: the plain version in f64); returns the largest absolute
    error."""
    errs = tol.errors(outs, refs, exact)
    bad = tol.failing(errs)
    ok = not bad and all(bool(torch.isfinite(o).all()) for o in outs)
    worst_max = max(range(len(errs)), key=lambda i: errs[i]["max_rel"])
    worst_mean = max(range(len(errs)), key=lambda i: errs[i]["mean_rel"] / errs[i]["mean_limit"])
    log(f"  {name}: {len(errs)} leaves, worst max_rel_err={errs[worst_max]['max_rel']:.3e} "
        f"(leaf {worst_max}; limit {tol.max_rel:g}), worst mean_rel_err against its limit "
        f"{errs[worst_mean]['mean_rel']:.3e} of {errs[worst_mean]['mean_limit']:.3e} (leaf "
        f"{worst_mean}) -> {'ok' if ok else f'FAIL leaves {bad}'}")
    if not ok:
        raise AssertionError(f"{name}: kernel gradients disagree with the plain version")
    return max(e["max_abs"] for e in errs)


def bwd_control(name, plain, tol, blind, exact=None) -> None:
    """The plain backward without its bf16 rounding must fail the limit on
    every leaf but those of `blind` (the module's BWD_CONTROL_BLIND, which
    keep only the max-error check)."""
    errs = tol.errors(plain(bf16=False), plain(), exact)
    bad = set(tol.failing(errs))
    blind = {i % len(errs) for i in blind}
    passed = [i for i in range(len(errs)) if i not in bad]
    least = min((errs[i]["mean_rel"] / errs[i]["mean_limit"] for i in bad), default=float("nan"))
    blind_errs = ", ".join(f"{i}: {errs[i]['mean_rel']:.3e}" for i in passed)
    log(f"  control {name} in f32 throughout: rejected on {len(bad)} of {len(errs)} leaves "
        f"(least mean_rel_err among them {least:.2f}x its limit); passes leaves {passed} "
        f"(mean_rel_err {blind_errs})")
    if not set(range(len(errs))) - blind <= bad:
        raise AssertionError(f"{name}: the tolerance does not reject the f32 control")


def phase_build() -> None:
    from mupe_tpu_torch.ops import build

    info = build.build()
    log(f"[1] kernels built={info['built']} in {info['seconds']:.1f} s "
        f"-> {info['path']}")
    if info["command"]:
        log(f"  {info['command']}")
    for line in info["log"].splitlines():
        if any(w in line for w in ("entry function", "registers", "spill", "rror")):
            log(f"  ptxas: {line.strip()}")
    build.library()


def phase_kernels(dev) -> dict:
    from mupe_tpu_torch.ops import fused_encoder as fe
    from mupe_tpu_torch.ops import tp_lstm as tl

    gen = torch.Generator().manual_seed(1)
    spec_a = fe.EncoderSpec(groups=GROUPS, head_dim=4)
    spec_c = fe.EncoderSpec(groups=GROUPS, head_dim=1)
    la = random_leaves(fe.leaf_shapes(spec_a), gen, dev)
    lc = random_leaves(fe.leaf_shapes(spec_c), gen, dev)
    tspec = tl.TPLSTMSpec(input_dim=16, hidden=64, t_steps=10, out_dim=15)
    lt = random_leaves(tspec.leaf_shapes(), gen, dev)
    results = {}
    log("[2] kernels vs plain versions on the card")
    log("  tolerance (mupe_tpu_torch/ops/tolerance.py): both sides round the same operands "
        "to bf16 and sum in f32 in another order, so a few values near a bf16 boundary round "
        "one ulp (2^-8) apart; the max error bounds those (and catches a wrong row), the mean "
        "error catches a missed rounding point, as the f32 control shows")
    s_main = NUM_ENVS * 3
    errs = []
    for s in (s_main, s_main + 1, MB_ROWS):
        x = (2.0 * torch.randn((s, spec_a.obs_dim), generator=gen)).to(dev)
        out_a, out_c = fe.encoder_pair_forward(spec_a, spec_c, la, lc, x)
        torch.cuda.synchronize()
        errs.append(compare(f"encoder_pair_forward S={s} actor", out_a,
                            fe.reference_apply(spec_a, la, x), fe.KERNEL_TOL,
                            in_f64(fe.reference_apply, spec_a, la, x)))
        errs.append(compare(f"encoder_pair_forward S={s} critic", out_c,
                            fe.reference_apply(spec_c, lc, x), fe.KERNEL_TOL,
                            in_f64(fe.reference_apply, spec_c, lc, x)))
    times = {}
    for s in (MB_ROWS, s_main):  # x of the act's size last: the control and kernel 2 use it
        x = (2.0 * torch.randn((s, spec_a.obs_dim), generator=gen)).to(dev)
        ms = cuda_time_ms(lambda: fe.encoder_pair_forward(spec_a, spec_c, la, lc, x))
        plain = cuda_time_ms(lambda: (fe.reference_apply(spec_a, la, x),
                                      fe.reference_apply(spec_c, lc, x)))
        b = bound(encoder_flops(spec_a, s) + encoder_flops(spec_c, s),
                  nbytes(x, *la, *lc) + s * (spec_a.head_dim + spec_c.head_dim) * 4)
        times[s] = (ms, plain, b)
        log(f"  encoder_pair_forward S={s}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    control(f"actor S={s_main}", lambda **k: fe.reference_apply(spec_a, la, x, **k),
            fe.KERNEL_TOL, in_f64(fe.reference_apply, spec_a, la, x))
    control(f"critic S={s_main}", lambda **k: fe.reference_apply(spec_c, lc, x, **k),
            fe.KERNEL_TOL, in_f64(fe.reference_apply, spec_c, lc, x))
    ms, plain, b = times[s_main]
    ms_mb, plain_mb, b_mb = times[MB_ROWS]
    results["encoder_pair_forward"] = dict(
        route="cuda", source="mupe_tpu_torch/csrc/fused_encoder.cu",
        replaces="mupe_tpu/ops/fused_encoder.py:502", max_abs_err=max(errs),
        ms=ms, plain_ms=plain, library_ms=None, **b, minibatch_rows=MB_ROWS,
        minibatch_ms=ms_mb, minibatch_plain_ms=plain_mb, minibatch_bound_ms=b_mb["bound_ms"])

    out = fe.encoder_forward(spec_c, lc, x)
    torch.cuda.synchronize()
    err = compare(f"encoder_forward S={s_main} head=1", out,
                  fe.reference_apply(spec_c, lc, x), fe.KERNEL_TOL,
                  in_f64(fe.reference_apply, spec_c, lc, x))
    ms = cuda_time_ms(lambda: fe.encoder_forward(spec_c, lc, x))
    plain = cuda_time_ms(lambda: fe.reference_apply(spec_c, lc, x))
    log(f"  encoder_forward S={s_main}: kernel {ms:.4f} ms, plain {plain:.4f} ms")
    results["encoder_forward"] = dict(
        route="cuda", source="mupe_tpu_torch/csrc/fused_encoder.cu",
        replaces="mupe_tpu/ops/fused_encoder.py:474", max_abs_err=err,
        ms=ms, plain_ms=plain, library_ms=None,
        **bound(encoder_flops(spec_c, s_main), nbytes(x, *lc, out)))

    results.update(phase_backward_kernels(dev, gen, spec_a, spec_c, la, lc))
    results.update(phase_tp_kernels(dev, gen, tspec, lt))
    results.update(phase_fps_kernel(dev, gen))
    results.update(phase_loss_kernels(dev, gen, spec_a, spec_c, la, lc))
    wide = phase_wide_kernels(dev)
    for name, extra in wide.items():
        results[name].update(extra)
    return results


def _bwd_blocks(fn: str, *args) -> int:
    """The persistent grid a backward kernel picks (its C helper)."""
    import ctypes

    from mupe_tpu_torch.ops import build

    blocks = ctypes.c_int(0)
    build.check(getattr(build.library(), fn)(*args, ctypes.byref(blocks)), fn)
    return blocks.value


BWD_EDGE_ROWS = (1, 7, 8, 15, 16, 17)  # the stage-A tile is 16 rows


def bwd_tol(fe, s):
    """BWD_KERNEL_TOL, with a mean limit of 5e-3 below 300 rows: a sum over a
    handful of rows averages no rounding flip away (tests/test_torch_kernels.py)."""
    import dataclasses

    return fe.BWD_KERNEL_TOL if s >= 300 else dataclasses.replace(fe.BWD_KERNEL_TOL, mean_rel=5e-3)


def hold_stages(tag, spec, flat, staged, ref_staged, ref_sums, tol, exact=None) -> float:
    """The two stages of a backward apart, each against its own plain version:
    stage A's column sums and head gradients with the plain products of its
    staged operands against `reference_backward_operands` then
    `reference_weight_grads` (its x slices bit-equal); stage B on stage A's
    staging against `reference_weight_grads` on it (WEIGHT_GRAD_TOL).
    Returns the largest absolute error."""
    from mupe_tpu_torch.ops import fused_encoder as fe

    s = ref_staged["dq"].shape[0]
    views = fe.split_flat(spec, flat)
    plain_b = fe.reference_weight_grads(spec, staged)
    ref = fe._canonical(spec, ref_sums, fe.reference_weight_grads(spec, ref_staged))
    got = [plain_b[i] if i in plain_b else views[i] for i in range(spec.n_leaves)]
    err = bwd_compare(f"{tag} stage A (column sums; staged operands through the plain products)",
                      got, ref, tol, exact)
    xs_equal = all(torch.equal(k[:, :s, :r.shape[-1]].float(), r)
                   for k, r in zip(staged["xs"], ref_staged["xs"]))
    if not xs_equal:
        raise AssertionError(f"{tag} stage A: the staged x slices are not the rows' bf16 values")
    again = flat.clone()
    fe.weight_grads([(spec, staged, again)])
    wl = fe.weight_leaves(spec)
    out = fe.split_flat(spec, again)
    return max(err, bwd_compare(f"{tag} stage B on stage A's staging", [out[i] for i in wl],
                                [plain_b[i] for i in wl], fe.WEIGHT_GRAD_TOL))


def phase_backward_kernels(dev, gen, spec_a, spec_c, la, lc) -> dict:
    """The encoder backward kernels at the update's shapes: one PPO
    minibatch (S = 16,384 (t, env) rows x 3 agents), the stage-A tile's edges
    and small S."""
    from mupe_tpu_torch.ops import fused_encoder as fe

    results = {}
    s_main = MB_ROWS
    errs = []
    log(f"  backward tolerance: per gradient leaf, scaled by the leaf's magnitude; the key-bias "
        f"gradient is analytically zero, bounded by {fe.BWD_KERNEL_TOL.noise_floor:g} of the "
        f"network's largest gradient; below 300 rows a mean limit of 5e-3; stage B alone "
        f"{fe.WEIGHT_GRAD_TOL.max_rel:g} max, {fe.WEIGHT_GRAD_TOL.mean_rel:g} mean (sum order "
        f"only)")
    edge = torch.Generator().manual_seed(5)  # the tile's edges: main-path draws as before
    for s, g in [(s_main, gen), (s_main + 1, gen)] + [(s, edge) for s in BWD_EDGE_ROWS]:
        x = (2.0 * torch.randn((s, spec_a.obs_dim), generator=g)).to(dev)
        da = torch.randn((s, 4), generator=g).to(dev)
        dc = torch.randn((s, 1), generator=g).to(dev)
        tol = bwd_tol(fe, s)
        exact = {}
        for nets, douts in (([(spec_a, la), (spec_c, lc)], [da, dc]),
                            ([(spec_a, la)], [da]), ([(spec_c, lc)], [dc])):
            grads = fe.encoder_backward(nets, x, douts)
            again = fe.encoder_backward(nets, x, douts)
            torch.cuda.synchronize()
            for (spec, leaves), d, g, g2 in zip(nets, douts, grads, again):
                tag = f"encoder_backward S={s} nets={len(nets)} head={spec.head_dim}"
                exact[spec.head_dim] = in_f64(fe.reference_backward, spec, leaves, x, d)
                errs.append(bwd_compare(tag, g, fe.reference_backward(spec, leaves, x, d), tol,
                                        exact[spec.head_dim]))
                if not all(torch.equal(u, v) for u, v in zip(g, g2)):
                    raise AssertionError(f"{tag}: two launches gave different bits")
        flats, stagings = fe._launch_operands(x, [(spec_a, la), (spec_c, lc)], [da, dc])
        torch.cuda.synchronize()
        for (spec, leaves), d, flat, st in zip(((spec_a, la), (spec_c, lc)), (da, dc), flats,
                                               stagings):
            errs.append(hold_stages(f"encoder_backward S={s} pair head={spec.head_dim}", spec,
                                    flat, st, *fe.reference_backward_operands(spec, leaves, x, d),
                                    tol, exact[spec.head_dim]))
        ones = torch.ones((s, 1), device=dev)
        (gc,) = fe.encoder_backward([(spec_c, lc)], x, [ones])
        _, gc2 = fe.encoder_backward([(spec_a, la), (spec_c, lc)], x, [da, ones])
        dbh = (gc[-1].item(), gc2[-1].item())
        log(f"  encoder_backward S={s}: repeat launches bit-identical; dout = 1 gives "
            f"dbh = {dbh[0]:.1f} (one net), {dbh[1]:.1f} (pair)")
        if dbh != (float(s), float(s)):
            raise AssertionError(f"encoder_backward S={s}: dbh {dbh} != S (a row was dropped)")
    x = (2.0 * torch.randn((s_main, spec_a.obs_dim), generator=gen)).to(dev)
    da = torch.randn((s_main, 4), generator=gen).to(dev)
    dc = torch.randn((s_main, 1), generator=gen).to(dev)
    bwd_control(f"actor backward S={s_main}",
                lambda **k: fe.reference_backward(spec_a, la, x, da, **k), fe.BWD_KERNEL_TOL,
                fe.BWD_CONTROL_BLIND, in_f64(fe.reference_backward, spec_a, la, x, da))
    bwd_control(f"critic backward S={s_main}",
                lambda **k: fe.reference_backward(spec_c, lc, x, dc, **k), fe.BWD_KERNEL_TOL,
                fe.BWD_CONTROL_BLIND, in_f64(fe.reference_backward, spec_c, lc, x, dc))
    pair = [(spec_a, la), (spec_c, lc)]
    ms = cuda_time_ms(lambda: fe.encoder_backward(pair, x, [da, dc]), runs=10)
    plain = cuda_time_ms(lambda: (fe.reference_backward(spec_a, la, x, da),
                                  fe.reference_backward(spec_c, lc, x, dc)), runs=10)
    ms_a = cuda_time_ms(lambda: fe._launch_operands(x, pair, [da, dc]), runs=10)
    flats, stagings = fe._launch_operands(x, pair, [da, dc])
    items = [(spec, st, g) for (spec, _), st, g in zip(pair, stagings, flats)]
    ms_b = cuda_time_ms(lambda: fe.weight_grads(items), runs=10)
    ms1 = cuda_time_ms(lambda: fe.encoder_backward([(spec_a, la)], x, [da]), runs=10)
    plain1 = cuda_time_ms(lambda: fe.reference_backward(spec_a, la, x, da), runs=10)
    b1 = bound(encoder_bwd_flops(spec_a, s_main), nbytes(x, da) + 2 * nbytes(*la))
    blocks = _bwd_blocks("mupe_encoder_bwd_blocks", *fe._groups_args(spec_a), 2,
                         fe.staged_rows(s_main))
    staged_mb = (fe.staging_bytes(spec_a, s_main) + fe.staging_bytes(spec_c, s_main)) / 1e6
    log(f"  encoder_backward S={s_main}: pair kernel {ms:.4f} ms (stage A {ms_a:.4f} ms, "
        f"stage B {ms_b:.4f} ms), plain {plain:.4f} ms; actor alone kernel {ms1:.4f} ms, plain "
        f"{plain1:.4f} ms, bound {b1['bound_ms']:.4f} ms ({b1['bound_by']}); stage A {blocks} "
        f"blocks per network; staged operands {staged_mb:.1f} MB a pair call")
    results["encoder_backward"] = dict(
        route="cuda", source="mupe_tpu_torch/csrc/fused_encoder_bwd.cu",
        replaces="mupe_tpu/ops/fused_encoder.py:483", max_abs_err=max(errs),
        ms=ms, plain_ms=plain, library_ms=None, stage_a_ms=ms_a, stage_b_ms=ms_b,
        stage_b_source="mupe_tpu_torch/csrc/weight_grad.cu", one_net_ms=ms1,
        **bound(encoder_bwd_flops(spec_a, s_main) + encoder_bwd_flops(spec_c, s_main),
                nbytes(x, da, dc) + 2 * nbytes(*la, *lc)))

    return results


def tp_check(tag, spec, lt, x, dy):
    """The TP forward and backward on x, dy against their plain versions with
    the floor-relative limits (the plain version in f64 given), and a second
    launch of each against the first's bits.  Returns the largest absolute
    errors (forward, backward)."""
    from mupe_tpu_torch.ops import tp_lstm as tl

    y, y2 = tl.tp_forward(spec, lt, x), tl.tp_forward(spec, lt, x)
    g, g2 = tl.tp_backward(spec, lt, x, dy), tl.tp_backward(spec, lt, x, dy)
    torch.cuda.synchronize()
    ef = compare(f"tp_forward {tag}", y, tl.reference_forward(spec, lt, x), tl.KERNEL_TOL,
                 in_f64(tl.reference_forward, spec, lt, x))
    eb = bwd_compare(f"tp_backward {tag}", g, tl.reference_backward(spec, lt, x, dy),
                     tl.BWD_KERNEL_TOL, in_f64(tl.reference_backward, spec, lt, x, dy))
    if not torch.equal(y, y2) or not all(torch.equal(u, v) for u, v in zip(g, g2)):
        raise AssertionError(f"tp {tag}: two launches gave different bits")
    return ef, eb


def tp_stage_calls(spec, lt, x, dy):
    """The TP backward's two stages apart, over its chunks of windows, as
    `tp_backward` runs them: (stage A, stage B)."""
    from mupe_tpu_torch.ops import tp_lstm as tl

    plan = tl.chunk_plan(spec, x, dy)
    flat = torch.empty(tl._leaf_offsets(spec)[-1], device=x.device)

    def stage_a():
        for xa, dya, staged, cs in plan:
            tl._launch_operands(spec, lt, xa, dya, flat, staged, cs)

    def stage_b():
        for _, _, staged, _ in plan:
            tl.tp_weight_grads(spec, staged, flat)

    return stage_a, stage_b


def cudnn_lstm_ms(spec, n, dev, gen) -> dict:
    """The yardstick: `torch.nn.LSTM(F, 64)` (cuDNN) forward, and forward +
    backward, over n windows of T steps, in bf16 where cuDNN takes it, else
    f16.  The recurrence only: no head and none of the reference's rounding
    points, so not the same function as the TP kernels."""
    for dtype in (torch.bfloat16, torch.float16):
        lstm = torch.nn.LSTM(spec.input_dim, spec.hidden, batch_first=True).to(dev, dtype)
        lstm.flatten_parameters()  # cuDNN's one weight buffer, as a user would run it
        x = torch.randn((n, spec.t_steps, spec.input_dim), generator=gen).to(dev, dtype)

        def fwd():
            with torch.no_grad():
                lstm(x)

        def fwd_bwd():
            lstm(x)[0][:, -1].float().sum().backward()

        try:
            fwd()
            fwd_bwd()
        except RuntimeError as e:  # cuDNN refuses this dtype: the next one
            log(f"  torch.nn.LSTM in {dtype}: {str(e).splitlines()[0][:120]}")
            continue
        return dict(cudnn_lstm_dtype=str(dtype).replace("torch.", ""),
                    cudnn_lstm_fwd_ms=cuda_time_ms(fwd, runs=10),
                    cudnn_lstm_fwd_bwd_ms=cuda_time_ms(fwd_bwd, runs=5))
    return dict(cudnn_lstm_dtype=None, cudnn_lstm_fwd_ms=None, cudnn_lstm_fwd_bwd_ms=None)


def phase_tp_kernels(dev, gen, tspec, lt) -> dict:
    """The TP-LSTM kernels: the forward at the rollout's N = 4,096 (and
    4,097) and the update's N = 241,664 windows, the backward at 241,664;
    both at the warp tile's edges (N = 1, 15, 16, 17) and at 241,665, at the
    main shape (16 inputs, 10 steps, 15 outputs) and at phase 7's (34, 20,
    30); windows past N add exact zeros; times, stage by stage, beside the
    plain versions and cuDNN's LSTM as a yardstick."""
    from mupe_tpu_torch.ops import tp_lstm as tl

    log(f"  TP limits: forward {tl.KERNEL_TOL}, backward per leaf {tl.BWD_KERNEL_TOL}, each "
        f"at least {tl.FLOOR_MULT:g} x the f32 plain version's error against it in f64")
    f, t, o = WIDE_TP
    wspec = tl.TPLSTMSpec(input_dim=f, hidden=64, t_steps=t, out_dim=o)
    wlt = random_leaves(wspec.leaf_shapes(), gen, dev)
    errs_f, errs_b = [], []
    edge = torch.Generator().manual_seed(6)
    for spec, leaves in ((tspec, lt), (wspec, wlt)):
        shape = f"F={spec.input_dim} T={spec.t_steps} O={spec.out_dim}"
        for n in TP_EDGE_WINDOWS + (NUM_ENVS, NUM_ENVS + 1, TP_WINDOWS, TP_WINDOWS + 1):
            g = gen if n >= NUM_ENVS else edge
            x = torch.randn((n, spec.t_steps, spec.input_dim), generator=g).to(dev)
            dy = torch.randn((n, spec.out_dim), generator=g).to(dev)
            ef, eb = tp_check(f"{shape} N={n}", spec, leaves, x, dy)
            errs_f.append(ef)
            errs_b.append(eb)
        # windows past N add exact zeros: 17 windows against 32 whose last 15
        # have a zero cotangent
        x = torch.randn((32, spec.t_steps, spec.input_dim), generator=edge).to(dev)
        dy = torch.randn((32, spec.out_dim), generator=edge).to(dev)
        dy[17:] = 0.0
        same = (torch.equal(tl.tp_forward(spec, leaves, x)[:17],
                            tl.tp_forward(spec, leaves, x[:17].contiguous()))
                and all(torch.equal(u, v) for u, v in zip(
                    tl.tp_backward(spec, leaves, x, dy),
                    tl.tp_backward(spec, leaves, x[:17].contiguous(), dy[:17].contiguous()))))
        log(f"  tp {shape}: 17 windows and 32 with 15 zero cotangents give the same bits: {same}")
        if not same:
            raise AssertionError(f"tp {shape}: windows past N changed the result")
    log("  tp: repeat launches bit-identical")
    xt = torch.randn((TP_WINDOWS, 10, 16), generator=gen).to(dev)
    dy = torch.randn((TP_WINDOWS, 15), generator=gen).to(dev)
    control(f"tp N={TP_WINDOWS}", lambda **k: tl.reference_forward(tspec, lt, xt, **k),
            tl.KERNEL_TOL, in_f64(tl.reference_forward, tspec, lt, xt))
    bwd_control(f"tp backward N={TP_WINDOWS}",
                lambda **k: tl.reference_backward(tspec, lt, xt, dy, **k), tl.BWD_KERNEL_TOL,
                tl.BWD_CONTROL_BLIND, in_f64(tl.reference_backward, tspec, lt, xt, dy))
    fwd = {}
    for n in (NUM_ENVS, TP_WINDOWS):  # the rollout's act, the update's TP step
        x = xt[:n].contiguous()
        y = tl.tp_forward(tspec, lt, x)
        fwd[n] = dict(ms=cuda_time_ms(lambda: tl.tp_forward(tspec, lt, x),
                                      runs=20 if n == NUM_ENVS else 10),
                      plain_ms=cuda_time_ms(lambda: tl.reference_forward(tspec, lt, x),
                                            runs=20 if n == NUM_ENVS else 3),
                      **bound(tp_flops(tspec, n), nbytes(x, *lt, y)))
    yard = cudnn_lstm_ms(tspec, TP_WINDOWS, dev, gen)
    for n, r in fwd.items():
        log(f"  tp_forward N={n}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"  torch.nn.LSTM(16, 64) at N={TP_WINDOWS}, T=10 ({yard['cudnn_lstm_dtype']}; the "
        f"recurrence alone, a yardstick): forward {yard['cudnn_lstm_fwd_ms']} ms, forward + "
        f"backward {yard['cudnn_lstm_fwd_bwd_ms']} ms")
    main = fwd[TP_WINDOWS]
    results = {"tp_forward": dict(
        route="cuda", source="mupe_tpu_torch/csrc/tp_lstm.cu",
        replaces="mupe_tpu/ops/tp_lstm.py:422", max_abs_err=max(errs_f),
        ms=fwd[NUM_ENVS]["ms"], plain_ms=fwd[NUM_ENVS]["plain_ms"], library_ms=None,
        bound_ms=fwd[NUM_ENVS]["bound_ms"], bound_by=fwd[NUM_ENVS]["bound_by"],
        windows=NUM_ENVS, update_windows=TP_WINDOWS, update_ms=main["ms"],
        update_plain_ms=main["plain_ms"], update_bound_ms=main["bound_ms"],
        cudnn_lstm_ms=yard["cudnn_lstm_fwd_ms"], cudnn_lstm_dtype=yard["cudnn_lstm_dtype"])}
    ms = cuda_time_ms(lambda: tl.tp_backward(tspec, lt, xt, dy), runs=5)
    stage_a, stage_b = tp_stage_calls(tspec, lt, xt, dy)
    ms_a = cuda_time_ms(stage_a, runs=5)
    ms_b = cuda_time_ms(stage_b, runs=5)
    plain = cuda_time_ms(lambda: tl.reference_backward(tspec, lt, xt, dy), runs=3)
    b = bound(tp_bwd_flops(tspec, TP_WINDOWS), nbytes(xt, dy) + 2 * nbytes(*lt))
    xw = torch.randn((TP_WINDOWS, t, f), generator=gen).to(dev)
    dyw = torch.randn((TP_WINDOWS, o), generator=gen).to(dev)
    ms_w = cuda_time_ms(lambda: tl.tp_backward(wspec, wlt, xw, dyw), runs=3)
    chunks = tl.window_chunks(tspec, TP_WINDOWS)
    log(f"  tp_backward N={TP_WINDOWS}: kernel {ms:.4f} ms (stage A {ms_a:.4f} ms, stage B "
        f"{ms_b:.4f} ms; {len(chunks)} chunks of windows, "
        f"{tl.staging_bytes(tspec, TP_WINDOWS) / 1e6:.1f} MB of staging), plain {plain:.4f} ms, "
        f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}); F={f} T={t} O={o}: {ms_w:.4f} ms")
    results["tp_backward"] = dict(
        route="cuda", source="mupe_tpu_torch/csrc/tp_lstm_bwd.cu",
        replaces="mupe_tpu/ops/tp_lstm.py:428", max_abs_err=max(errs_b),
        ms=ms, plain_ms=plain, library_ms=None, **b, stage_a_ms=ms_a, stage_b_ms=ms_b,
        stage_b_source="mupe_tpu_torch/csrc/weight_grad.cu", wide_ms=ms_w,
        wide_shape=list(WIDE_TP), cudnn_lstm_ms=yard["cudnn_lstm_fwd_bwd_ms"],
        cudnn_lstm_dtype=yard["cudnn_lstm_dtype"])
    for name, extra in phase_tp_limit(dev).items():
        results[name].update(extra)
    return results


def phase_tp_limit(dev) -> dict:
    """The TP kernels at phase 9's shape (91 inputs, 40 steps, 120 outputs;
    the generic instance: 6 input k-tiles, two head passes, stage B's dwi
    and dwfc past one product) at the warp tile's edges and at its update's
    98,304 windows, the f32 control rejected there; times beside the plain
    versions.  Returns, per kernel, the times."""
    from mupe_tpu_torch.ops import tp_lstm as tl

    f, t, o = LIMIT_TP
    spec = tl.TPLSTMSpec(input_dim=f, hidden=64, t_steps=t, out_dim=o)
    gen = torch.Generator().manual_seed(9)
    lt = random_leaves(spec.leaf_shapes(), gen, dev)
    shape = f"F={f} T={t} O={o}"
    for n in TP_EDGE_WINDOWS + (LIMIT_TP_WINDOWS,):
        x = torch.randn((n, t, f), generator=gen).to(dev)
        dy = torch.randn((n, o), generator=gen).to(dev)
        tp_check(f"{shape} N={n}", spec, lt, x, dy)
    control(f"tp {shape} N={LIMIT_TP_WINDOWS}",
            lambda **k: tl.reference_forward(spec, lt, x, **k), tl.KERNEL_TOL,
            in_f64(tl.reference_forward, spec, lt, x))
    bwd_control(f"tp backward {shape} N={LIMIT_TP_WINDOWS}",
                lambda **k: tl.reference_backward(spec, lt, x, dy, **k), tl.BWD_KERNEL_TOL,
                tl.BWD_CONTROL_BLIND, in_f64(tl.reference_backward, spec, lt, x, dy))
    ms_f = cuda_time_ms(lambda: tl.tp_forward(spec, lt, x), runs=10)
    plain_f = cuda_time_ms(lambda: tl.reference_forward(spec, lt, x), runs=3)
    ms_b = cuda_time_ms(lambda: tl.tp_backward(spec, lt, x, dy), runs=3)
    plain_b = cuda_time_ms(lambda: tl.reference_backward(spec, lt, x, dy), runs=3)
    bf = bound(tp_flops(spec, LIMIT_TP_WINDOWS), nbytes(x, *lt) + LIMIT_TP_WINDOWS * o * 4)
    bb = bound(tp_bwd_flops(spec, LIMIT_TP_WINDOWS), nbytes(x, dy) + 2 * nbytes(*lt))
    log(f"  tp {shape} N={LIMIT_TP_WINDOWS} ({len(tl.window_chunks(spec, LIMIT_TP_WINDOWS))} "
        f"chunks of windows): forward kernel {ms_f:.4f} ms, plain {plain_f:.4f} ms, bound "
        f"{bf['bound_ms']:.4f} ms; backward kernel {ms_b:.4f} ms, plain {plain_b:.4f} ms, bound "
        f"{bb['bound_ms']:.4f} ms")
    return {"tp_forward": dict(limit_shape=list(LIMIT_TP), limit_windows=LIMIT_TP_WINDOWS,
                               limit_ms=ms_f, limit_plain_ms=plain_f,
                               limit_bound_ms=bf["bound_ms"]),
            "tp_backward": dict(limit_shape=list(LIMIT_TP), limit_windows=LIMIT_TP_WINDOWS,
                                limit_ms=ms_b, limit_plain_ms=plain_b,
                                limit_bound_ms=bb["bound_ms"])}


def fps_pool(n: int, gen, dev, keep_last=None, d: int = FPS_D):
    """An AEG-like FPS pool: normalised tasks (uniform in [0, 1)); with
    `keep_last`, the last rows (the eval tasks) kept at random."""
    pts = torch.rand((n, d), generator=gen)
    valid = torch.ones(n, dtype=torch.bool)
    if keep_last:
        valid[-keep_last:] = torch.rand(keep_last, generator=gen) < 0.6
    return pts.to(dev), valid.to(dev)


def fps_tie_pool(n: int, gen, dev):
    """Duplicate far rows in different blocks' ranges (at n/7, 3n/7 and
    6n/7, and a second pair at n/5 and 4n/5): the lower index must win
    each tie across blocks, then the copies' minima fall to 0."""
    pts, valid = fps_pool(n, gen, dev)
    pts[[n // 7, 3 * n // 7, 6 * n // 7]] = 2.0
    pts[[n // 5, 4 * n // 5]] = -1.5
    return pts, valid


def fps_repeat_pool(n: int, gen, dev, distinct: int = 50):
    """`distinct` rows repeated over the whole pool: ties in every round."""
    base = torch.rand((distinct, FPS_D), generator=gen)
    return base[torch.arange(n) % distinct].to(dev), torch.ones(n, dtype=torch.bool, device=dev)


def fps_sparse_pool(n: int, gen, dev, n_valid: int):
    """Fewer valid points than K, spread over the whole pool (every block's
    range): once all are chosen, the lowest valid index repeats."""
    pts, _ = fps_pool(n, gen, dev)
    valid = torch.zeros(n, dtype=torch.bool)
    valid[torch.randperm(n, generator=gen)[:n_valid]] = True
    return pts, valid.to(dev)


def fps_check(tag, pts, valid, k) -> None:
    """The kernel against `reference_fps`: index for index, bit-identical on
    a repeat, no invalid point chosen; fails the run otherwise."""
    from mupe_tpu_torch.ops import fps

    n, d = pts.shape
    start = torch.argmax(valid.to(torch.uint8))
    c, inst = fps.plan(n, d, pts.device)
    idx = fps.farthest_point_sampling(pts, k, valid, start)
    again = fps.farthest_point_sampling(pts, k, valid, start)
    ref = fps.reference_fps(pts, k, valid, start)
    torch.cuda.synchronize()
    bad = int((~valid[idx.long()]).sum())
    tag = f"farthest_point_sampling N={n} D={d} K={k} {tag} (cluster {c}, {inst})"
    log(f"  {tag}: indices equal to the plain version: {torch.equal(idx, ref)}, repeat "
        f"bit-identical: {torch.equal(idx, again)}, invalid chosen: {bad}")
    if not (torch.equal(idx, ref) and torch.equal(idx, again) and bad == 0):
        raise AssertionError(f"{tag}: the FPS kernel disagrees with its plain version")


def fps_time(n, d, k, gen, dev, plain=False) -> dict:
    """The kernel's time (and the plain version's) at a pool of n points."""
    from mupe_tpu_torch.ops import fps

    pts, valid = fps_pool(n, gen, dev, NUM_ENVS, d)
    start = torch.argmax(valid.to(torch.uint8))
    c, inst = fps.plan(n, d, dev)
    ms = cuda_time_ms(lambda: fps.farthest_point_sampling(pts, k, valid, start), runs=5)
    b = bound(3 * (k - 1) * n * d, nbytes(pts, valid) + 4 + 4 * k, PEAK_F32_FLOPS)
    out = dict(cluster=c, instance=inst, ms=ms, us_per_round=ms * 1e3 / (k - 1), **b)
    if plain:
        out["plain_ms"] = cuda_time_ms(lambda: fps.reference_fps(pts, k, valid, start),
                                       runs=2, warmup=1)
    log(f"  farthest_point_sampling N={n} D={d} K={k}: cluster {c}, {inst}: kernel {ms:.4f} ms "
        f"({out['us_per_round']:.4f} us a round)"
        + (f", plain {out['plain_ms']:.4f} ms" if plain else "")
        + f", bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return out


def phase_fps_kernel(dev, gen) -> dict:
    """The FPS kernel (one thread-block cluster) index for index equal to its
    plain version (the same f32 sums in the same order), bit-identical on a
    repeat, no invalid point chosen: at the AEG's pool, at the cluster's
    block-split edges there, past the shared memory's capacity (the streamed
    instance, and at the largest N the kernel takes), at phase 9's task
    width, with ties across blocks and with fewer valid points than K; then
    timed at the AEG's pool (the register instance) and past the old
    49,152-row limit (streamed)."""
    from mupe_tpu_torch.ops import fps

    k = AEG_BUFFER
    for n, keep_last in ((FPS_N, NUM_ENVS), (FPS_N, None), (FPS_N + 1, NUM_ENVS + 1)):
        pts, valid = fps_pool(n, gen, dev, keep_last)
        fps_check(f"last {keep_last} kept at random" if keep_last else "all valid", pts, valid, k)
    c, inst = fps.plan(FPS_N, FPS_D, dev)
    rows = -(-FPS_N // c)
    for n in (c * rows - 1, c * rows, c * rows + 1):
        pts, valid = fps_pool(n, gen, dev, NUM_ENVS)
        fps_check(f"block-split edge ({rows} rows a block at N={FPS_N})", pts, valid, k)
    pts, valid = fps_pool(FPS_N, gen, dev, NUM_ENVS, FPS_D_LIMIT)
    fps_check("phase 9's task width", pts, valid, k)
    for n in (FPS_N, FPS_STREAMED_N):
        pts, valid = fps_tie_pool(n, gen, dev)
        fps_check("duplicate far rows in different blocks", pts, valid, 500)
    pts, valid = fps_repeat_pool(FPS_N, gen, dev)
    fps_check("50 distinct rows repeated", pts, valid, 500)
    pts, valid = fps_sparse_pool(FPS_N, gen, dev, 300)
    fps_check("300 valid points", pts, valid, 500)
    pts, valid = fps_pool(FPS_STREAMED_N, gen, dev, NUM_ENVS)
    fps_check("past the old 49,152-row limit", pts, valid, 500)
    pts, valid = fps_pool(fps.MAX_N, gen, dev, NUM_ENVS)
    fps_check("the largest N the kernel takes", pts, valid, 32)
    del pts, valid
    res = fps_time(FPS_N, FPS_D, k, gen, dev, plain=True)
    streamed = fps_time(FPS_STREAMED_N, FPS_D, k, gen, dev)
    return {"farthest_point_sampling": dict(
        route="cuda", source="mupe_tpu_torch/csrc/fps.cu",
        replaces="mupe_tpu/ops/fps_pallas.py:25", max_abs_err=0.0, library_ms=None, **res,
        streamed_n=FPS_STREAMED_N, streamed_cluster=streamed["cluster"],
        streamed_instance=streamed["instance"], streamed_ms=streamed["ms"],
        streamed_us_per_round=streamed["us_per_round"],
        streamed_bound_ms=streamed["bound_ms"])}


def loss_inputs(spec_a, spec_c, la, lc, x, gen, saturate=False):
    """The in-kernel loss's inputs for the rows x, as the kernels take them:
    (loss, (log_std, x, act, logp_old, adv, v_old, ret)).  Actions drawn from
    the policy about the plain actor's mean (log_std about -1, so that the
    ratio feels the forward's rounding); logp_old such that the ratio under
    the plain forward lies in [0.5, 1.64], 2e-2 or more from the clip rails
    1 +- eps, and v_old such that |v - v_old| lies 1e-2 or more from eps: a
    kernel's forward parts from the plain one by well under 1e-3 (its log-prob
    by z / sigma times that), which then flips no row's branch (a flip moves
    that row's output by its whole size).
    Returns within about 0.3 of the value, every 500th row 12-16 away (the
    Huber loss's linear branch, delta 10).  With `saturate`, a sixth of the
    rows' log-ratios at +40 and a sixth at -40."""
    from mupe_tpu_torch.learning import MAPPOCfg
    from mupe_tpu_torch.ops import fused_encoder as fe

    cfg = MAPPOCfg()
    eps, dev, s = cfg.clip_param, x.device, x.shape[0]

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    mean, vout = fe.reference_apply(spec_a, la, x), fe.reference_apply(spec_c, lc, x)
    log_std = -1.0 + 0.3 * rnd(spec_a.head_dim)
    act = mean + torch.exp(log_std) * rnd(s, spec_a.head_dim)
    z = (act - mean) / torch.exp(log_std)
    logp = torch.sum(-0.5 * z * z - log_std - fe._LOG_SQRT_2PI, dim=-1, keepdim=True)
    ratio = 0.5 + 1.1 * torch.rand((s, 1), generator=gen).to(dev)
    for rail in (1.0 - eps, 1.0 + eps):
        ratio = torch.where((ratio - rail).abs() < 2e-2, ratio + 4e-2, ratio)
    logp_old = logp - torch.log(ratio)
    if saturate:
        k = s // 6
        logp_old[:k] += 40.0
        logp_old[s - k:] -= 40.0
    off = 0.1 * rnd(s, 1)
    off = torch.where((off.abs() - eps).abs() < 1e-2, 1.25 * off, off)
    loss = fe.PPOLossCfg(clip_param=eps, huber_delta=cfg.huber_delta,
                         action_dim=spec_a.head_dim, n_rows=s)
    ret = vout + 0.3 * rnd(s, 1)
    n_far = (s + 499) // 500
    ret[::500] += torch.sign(rnd(n_far, 1)) * (12.0 + 4.0 * torch.rand((n_far, 1),
                                                                       generator=gen).to(dev))
    return loss, (log_std, x, act, logp_old, rnd(s, 1), vout - off, ret)


def columns_compare(name, out, ref, tol, exact=None) -> float:
    """A stats matrix against its plain version column by column (each
    column at its own scale; `exact`: the plain version in f64); returns the
    largest absolute error."""
    errs = [tol.errors(out[:, c], ref[:, c], None if exact is None else exact[:, c])
            for c in range(ref.shape[1])]
    bad = [c for c, e in enumerate(errs) if not tol.holds(e)]
    ok = not bad and bool(torch.isfinite(out).all())
    worst_max = max(range(len(errs)), key=lambda c: errs[c]["max_rel"])
    worst = max(range(len(errs)), key=lambda c: errs[c]["mean_rel"])
    log(f"  {name}: {len(errs)} columns, worst max_rel_err={errs[worst_max]['max_rel']:.3e} "
        f"(column {worst_max}), worst mean_rel_err={errs[worst]['mean_rel']:.3e} (column "
        f"{worst}) (tol {tol.max_rel:g} max, {tol.mean_rel:g} mean per column)"
        f" -> {'ok' if ok else f'FAIL columns {bad}'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max(e["max_abs"] for e in errs)


def loss_control(name, args) -> None:
    """The plain forward + loss without its bf16 rounding must fail the
    limits (KERNEL_TOL, LOSS_STATS_TOL) on dmu, dv1 and dv2 and on every
    stats column that the forward moves (all but R and R², the returns)."""
    from mupe_tpu_torch.ops import fused_encoder as fe

    ref = fe.reference_pair_fwd_loss(*args)
    ctl = fe.reference_pair_fwd_loss(*args, bf16=False)
    exact = in_f64(fe.reference_pair_fwd_loss, *args)
    parts = {n: (fe.KERNEL_TOL, fe.KERNEL_TOL.errors(c, r, e))
             for n, c, r, e in zip(("dmu", "dv1", "dv2"), ctl[:3], ref[:3], exact[:3])}
    for c in range(ref[3].shape[1]):
        if c not in (fe._SUM_RET, fe._SUM_RET2):
            parts[f"stats[{c}]"] = (fe.LOSS_STATS_TOL, fe.LOSS_STATS_TOL.errors(
                ctl[3][:, c], ref[3][:, c], exact[3][:, c]))
    passed = [n for n, (tol, e) in parts.items() if tol.holds(e)]
    least = min(e["mean_rel"] for _, e in parts.values())
    log(f"  control {name} in f32 throughout: rejected on {len(parts) - len(passed)} of "
        f"{len(parts)} outputs (least mean_rel_err {least:.3e}); passes {passed}")
    if passed:
        raise AssertionError(f"{name}: the tolerance does not reject the f32 control")


def check_forward_bits(tag, args, out9, out10) -> None:
    """Every kernel that runs the encoder forward runs `tc_forward` (or its
    streamed twin), whose per-row arithmetic does not depend on the tile's
    height, so at every spec: the fwdloss kernel's dv1, dv2 and stats are the
    agrad kernel's bits, and the pair forward's value through the plain loss
    math gives their dv1 bit for bit (dv1 = (v - R) / S, clipped, one f32
    rounding an operation on both sides); its mean gives the fwdloss
    kernel's dmu within a few ulps (the kernel's `expf` and sum order against
    torch's).  A mismatch fails the run."""
    from mupe_tpu_torch.ops import fused_encoder as fe

    spec_a, spec_c, loss, la, lc, log_std, x, act, logp_old, adv, v_old, ret = args
    mean, vout = fe.encoder_pair_forward(spec_a, spec_c, la, lc, x)
    dmu, dv1 = fe.reference_loss_math(loss, mean, vout, act, logp_old, adv, v_old, ret,
                                      log_std)[:2]
    same = all(torch.equal(u, v) for u, v in zip(out9[1:], out10[:3]))
    value = torch.equal(dv1, out9[1]) and torch.equal(dv1, out10[0])
    scale = torch.clamp(dmu.abs(), min=max(1e-6 * float(dmu.abs().max()), 1e-30))
    dmu_err = float(((out9[0] - dmu).abs() / scale).max())
    log(f"  forward bits {tag}: pair_forward_loss's dv1, dv2, stats bit-identical to "
        f"pair_forward_loss_agrad's: {same}; encoder_pair_forward's value through the plain "
        f"loss math gives their dv1: {value}; its mean gives pair_forward_loss's dmu within "
        f"{dmu_err:.2e} relative (tol 1e-5)")
    if not (same and value and dmu_err <= 1e-5):
        raise AssertionError(f"forward bits {tag}: the forward kernels' bits differ")


def phase_loss_kernels(dev, gen, spec_a, spec_c, la, lc) -> dict:
    """The in-kernel loss kernels at the update's minibatch (S = 49,152 rows
    and one more), against their plain versions on the card; a third of the
    rows saturated in one case."""
    from mupe_tpu_torch.ops import fused_encoder as fe

    s_main = MB_ROWS
    errs9, errs10 = [], []
    log("  in-kernel loss kernels: inputs from `loss_inputs` (ratios 2e-2, value offsets 1e-2 "
        "or more from the clip rails); per-row outputs to KERNEL_TOL, stats column by column, "
        "the agrad kernel's gradients to BWD_KERNEL_TOL (mean 5e-3 below 300 rows)")
    edge = torch.Generator().manual_seed(6)  # the tile's edges: main-path draws as before
    cases = ([(s_main, False, gen), (s_main + 1, False, gen), (s_main, True, gen)]
             + [(s, False, edge) for s in BWD_EDGE_ROWS])
    for s, saturate, g in cases:
        x = (2.0 * torch.randn((s, spec_a.obs_dim), generator=g)).to(dev)
        loss, rows = loss_inputs(spec_a, spec_c, la, lc, x, g, saturate)
        args = (spec_a, spec_c, loss, la, lc, *rows)
        out9 = fe.pair_forward_loss(*args)
        out10 = fe.pair_forward_loss_agrad(*args)
        again = fe.pair_forward_loss_agrad(*args)
        torch.cuda.synchronize()
        ref9 = fe.reference_pair_fwd_loss(*args)
        ex9 = in_f64(fe.reference_pair_fwd_loss, *args)
        tag = f"S={s}" + (", a third of the rows saturated" if saturate else "")
        rows_tol, stats_tol = fe.loss_row_tols(s)
        for name, o, r, e in zip(("dmu", "dv1", "dv2"), out9[:3], ref9[:3], ex9[:3]):
            errs9.append(compare(f"pair_forward_loss {tag} {name}", o, r, rows_tol, e))
        errs9.append(columns_compare(f"pair_forward_loss {tag} stats", out9[3], ref9[3],
                                     stats_tol, ex9[3]))
        for name, o, r, e in zip(("dv1", "dv2"), out10[:2], ref9[1:3], ex9[1:3]):
            errs10.append(compare(f"pair_forward_loss_agrad {tag} {name}", o, r, rows_tol, e))
        errs10.append(columns_compare(f"pair_forward_loss_agrad {tag} stats", out10[2], ref9[3],
                                      stats_tol, ex9[3]))
        tol = bwd_tol(fe, s)
        ex10 = in_f64(fe.reference_pair_fwd_loss_agrad, *args)[3]
        errs10.append(bwd_compare(f"pair_forward_loss_agrad {tag} actor gradients", out10[3],
                                  fe.reference_backward(spec_a, la, x, ref9[0]), tol, ex10))
        outs, flat, staged = fe._launch_agrad_operands(*args)
        torch.cuda.synchronize()
        _, _, _, ref_staged, ref_sums = fe.reference_agrad_operands(*args)
        errs10.append(hold_stages(f"pair_forward_loss_agrad {tag}", spec_a, flat, staged,
                                  ref_staged, ref_sums, tol, ex10))
        repeat = all(torch.equal(u, v) for u, v in zip((*out10[:3], *out10[3]),
                                                       (*again[:3], *again[3])))
        log(f"  pair_forward_loss_agrad {tag}: repeat launch bit-identical: {repeat}")
        if not repeat:
            raise AssertionError(f"pair_forward_loss_agrad {tag}: two launches gave different bits")
        check_forward_bits(tag, args, out9, out10)
        errs10.append(compare(f"pair_forward_loss_agrad {tag} head-bias gradient vs the column "
                              f"sum of the plain dmu", out10[3][-1], ref9[0].sum(0),
                              fe.DMU_SUM_TOL))
        if saturate:
            k = s // 6
            zero = float(torch.cat([out9[0][:k], out9[0][s - k:]]).abs().max())
            log(f"  pair_forward_loss {tag}: largest |dmu| on the saturated rows {zero:g}")
            if zero != 0.0:
                raise AssertionError("a saturated row has a nonzero gradient")
    x = (2.0 * torch.randn((s_main, spec_a.obs_dim), generator=gen)).to(dev)
    loss, rows = loss_inputs(spec_a, spec_c, la, lc, x, gen)
    args = (spec_a, spec_c, loss, la, lc, *rows)
    loss_control(f"forward + loss S={s_main}", args)
    bwd_control(f"agrad actor gradients S={s_main}",
                lambda **k: fe.reference_pair_fwd_loss_agrad(*args, **k)[3], fe.BWD_KERNEL_TOL,
                fe.BWD_CONTROL_BLIND, in_f64(fe.reference_pair_fwd_loss_agrad, *args)[3])
    ms9 = cuda_time_ms(lambda: fe.pair_forward_loss(*args))
    plain9 = cuda_time_ms(lambda: fe.reference_pair_fwd_loss(*args))
    ms10 = cuda_time_ms(lambda: fe.pair_forward_loss_agrad(*args), runs=10)
    plain10 = cuda_time_ms(lambda: fe.reference_pair_fwd_loss_agrad(*args), runs=10)
    ms10_a = cuda_time_ms(lambda: fe._launch_agrad_operands(*args), runs=10)
    _, flat, staged = fe._launch_agrad_operands(*args)
    ms10_b = cuda_time_ms(lambda: fe.weight_grads([(spec_a, staged, flat)]), runs=10)
    a = spec_a.head_dim
    moved_in = nbytes(*rows, *la, *lc)
    b9 = bound(encoder_flops(spec_a, s_main) + encoder_flops(spec_c, s_main),
               moved_in + s_main * (a + 2 + fe._N_STATS + a) * 4)
    b10 = bound(encoder_flops(spec_c, s_main) + encoder_bwd_flops(spec_a, s_main),
                moved_in + s_main * (2 + fe._N_STATS + a) * 4 + nbytes(*la))
    blocks = _bwd_blocks("mupe_encoder_fwd_loss_agrad_blocks", *fe._groups_args(spec_a),
                         fe.staged_rows(s_main))
    log(f"  pair_forward_loss S={s_main}: kernel {ms9:.4f} ms, plain {plain9:.4f} ms, bound "
        f"{b9['bound_ms']:.4f} ms ({b9['bound_by']}); pair_forward_loss_agrad: kernel "
        f"{ms10:.4f} ms (stage A {ms10_a:.4f} ms, stage B {ms10_b:.4f} ms), plain "
        f"{plain10:.4f} ms, bound {b10['bound_ms']:.4f} ms ({b10['bound_by']}), {blocks} "
        f"stage-A blocks; staged operands {fe.staging_bytes(spec_a, s_main) / 1e6:.1f} MB a call")
    src = "mupe_tpu_torch/csrc/fused_encoder_loss.cu"
    return {
        "pair_forward_loss": dict(
            route="cuda", source=src, replaces="mupe_tpu/ops/fused_encoder.py:568",
            max_abs_err=max(errs9), ms=ms9, plain_ms=plain9, library_ms=None, **b9),
        "pair_forward_loss_agrad": dict(
            route="cuda", source=src, replaces="mupe_tpu/ops/fused_encoder.py:730",
            max_abs_err=max(errs10), ms=ms10, plain_ms=plain10, library_ms=None,
            stage_a_ms=ms10_a, stage_b_ms=ms10_b,
            stage_b_source="mupe_tpu_torch/csrc/weight_grad.cu", **b10),
    }


def fwd_tol(fe, spec, s):
    """The forward's limits at s rows: KERNEL_TOL, and for the streamed
    specs (`tile_spec_ok` false) below SMALL_S_ROWS the loss kernels'
    per-row limits (`loss_row_tols`): over a handful of rows the mean error
    is one row's, and at 28 tokens one bf16 flip in a row moves it past 1e-4
    where the floor of that draw is 0 (tests/test_torch_streamed_kernels.py)."""
    return fe.KERNEL_TOL if fe.tile_spec_ok(spec) else fe.loss_row_tols(s)[0]


def phase_wide_kernels(dev) -> dict:
    """Every encoder kernel at 7 tokens, at 8 tokens with a 50-wide group
    (phase 7's observation; stage A's and the agrad kernel's 8-row tile), at
    12 tokens and at 16 tokens over 148 columns (phase 8's; the kernels'
    16-token instances), and past the tile instances at 17 tokens and at 28
    tokens over 261 columns with a 140-wide group (phase 9's; the streamed
    instances), at the tile's edges and at the main path's sizes; each
    against its plain version with the main path's limits, the forward
    kernels' bits checked (`check_forward_bits`), the f32 control rejected
    at the 28-token spec.  Returns, per kernel, its times at the 8-, 16-, 17-
    and 28-token specs."""
    from mupe_tpu_torch.ops import fused_encoder as fe

    tile_gen = torch.Generator().manual_seed(7)
    streamed_gen = torch.Generator().manual_seed(17)  # the tile specs' draws as before
    out = {}
    timed = {WIDE_GROUPS: "wide", TOK16_GROUPS: "tok16", TOK17_GROUPS: "tok17",
             LIMIT_GROUPS: "limit"}
    log(f"  wide specs: {TOK7_GROUPS} (7 tokens), {WIDE_GROUPS} (8 tokens, state_self 50), "
        f"{TOK12_GROUPS} (12 tokens), {TOK16_GROUPS} (16 tokens, 148 columns); streamed: "
        f"{TOK17_GROUPS} (17 tokens), {LIMIT_GROUPS} (28 tokens, 261 columns, state_self 140)")
    for groups in (TOK7_GROUPS, WIDE_GROUPS, TOK12_GROUPS, TOK16_GROUPS, TOK17_GROUPS,
                   LIMIT_GROUPS):
        spec_a = fe.EncoderSpec(groups=groups, head_dim=4)
        spec_c = fe.EncoderSpec(groups=groups, head_dim=1)
        gen = tile_gen if fe.tile_spec_ok(spec_a) else streamed_gen
        la = random_leaves(fe.leaf_shapes(spec_a), gen, dev)
        lc = random_leaves(fe.leaf_shapes(spec_c), gen, dev)
        tag = f"{spec_a.n_tokens} tokens"
        if not fe.tile_spec_ok(spec_a):
            tag += " (streamed)"
        for s in TILE_EDGE_ROWS + (NUM_ENVS * 3, MB_ROWS):
            x = (2.0 * torch.randn((s, spec_a.obs_dim), generator=gen)).to(dev)
            mean, vout = fe.encoder_pair_forward(spec_a, spec_c, la, lc, x)
            compare(f"encoder_pair_forward {tag} S={s} actor", mean,
                    fe.reference_apply(spec_a, la, x), fwd_tol(fe, spec_a, s),
                    in_f64(fe.reference_apply, spec_a, la, x))
            compare(f"encoder_pair_forward {tag} S={s} critic", vout,
                    fe.reference_apply(spec_c, lc, x), fwd_tol(fe, spec_c, s),
                    in_f64(fe.reference_apply, spec_c, lc, x))
            if s == NUM_ENVS * 3:
                continue
            da = torch.randn((s, 4), generator=gen).to(dev)
            ones = torch.ones((s, 1), device=dev)
            tol = bwd_tol(fe, s)
            pair = [(spec_a, la), (spec_c, lc)]
            ga, gc = fe.encoder_backward(pair, x, [da, ones])
            exact = [in_f64(fe.reference_backward, spec, leaves, x, d)
                     for (spec, leaves), d in zip(pair, (da, ones))]
            bwd_compare(f"encoder_backward {tag} S={s} actor", ga,
                        fe.reference_backward(spec_a, la, x, da), tol, exact[0])
            bwd_compare(f"encoder_backward {tag} S={s} critic", gc,
                        fe.reference_backward(spec_c, lc, x, ones), tol, exact[1])
            if gc[-1].item() != float(s):
                raise AssertionError(f"encoder_backward {tag} S={s}: dbh {gc[-1].item()} != S")
            flats, stagings = fe._launch_operands(x, pair, [da, ones])
            for (spec, leaves), d, flat, st, ex in zip(pair, (da, ones), flats, stagings, exact):
                hold_stages(f"encoder_backward {tag} S={s} head={spec.head_dim}", spec, flat, st,
                            *fe.reference_backward_operands(spec, leaves, x, d), tol, ex)
            loss, rows = loss_inputs(spec_a, spec_c, la, lc, x, gen)
            args = (spec_a, spec_c, loss, la, lc, *rows)
            rows_tol, stats_tol = fe.loss_row_tols(s)
            ref9 = fe.reference_pair_fwd_loss(*args)
            ex9 = in_f64(fe.reference_pair_fwd_loss, *args)
            out9, out10 = fe.pair_forward_loss(*args), fe.pair_forward_loss_agrad(*args)
            for name, o, r, e in zip(("dmu", "dv1", "dv2", "agrad dv1", "agrad dv2"),
                                     (*out9[:3], *out10[:2]), (*ref9[:3], *ref9[1:3]),
                                     (*ex9[:3], *ex9[1:3])):
                compare(f"pair_forward_loss {tag} S={s} {name}", o, r, rows_tol, e)
            columns_compare(f"pair_forward_loss {tag} S={s} stats", out9[3], ref9[3], stats_tol,
                            ex9[3])
            columns_compare(f"pair_forward_loss_agrad {tag} S={s} stats", out10[2], ref9[3],
                            stats_tol, ex9[3])
            bwd_compare(f"pair_forward_loss_agrad {tag} S={s} actor gradients", out10[3],
                        fe.reference_backward(spec_a, la, x, ref9[0]), tol,
                        in_f64(fe.reference_pair_fwd_loss_agrad, *args)[3])
            check_forward_bits(f"{tag} S={s}", args, out9, out10)
            if s == MB_ROWS and groups == LIMIT_GROUPS:
                control(f"actor {tag} S={s}", lambda **k: fe.reference_apply(spec_a, la, x, **k),
                        fe.KERNEL_TOL, in_f64(fe.reference_apply, spec_a, la, x))
                bwd_control(f"actor backward {tag} S={s}",
                            lambda **k: fe.reference_backward(spec_a, la, x, da, **k),
                            fe.BWD_KERNEL_TOL, fe.BWD_CONTROL_BLIND, exact[0])
                loss_control(f"forward + loss {tag} S={s}", args)
            if s == MB_ROWS and groups in timed:
                key = timed[groups]
                pair_ms = cuda_time_ms(lambda: fe.encoder_pair_forward(spec_a, spec_c, la, lc, x))
                bwd_ms = cuda_time_ms(lambda: fe.encoder_backward(pair, x, [da, ones]), runs=10)
                ms10 = cuda_time_ms(lambda: fe.pair_forward_loss_agrad(*args), runs=10)
                ms9 = cuda_time_ms(lambda: fe.pair_forward_loss(*args), runs=10)
                blocks = _bwd_blocks("mupe_encoder_bwd_blocks", *fe._groups_args(spec_a), 2,
                                     fe.staged_rows(s))
                log(f"  {tag} S={s}: encoder_pair_forward {pair_ms:.4f} ms, encoder_backward "
                    f"pair {bwd_ms:.4f} ms ({blocks} stage-A blocks a network), "
                    f"pair_forward_loss {ms9:.4f} ms, pair_forward_loss_agrad {ms10:.4f} ms")
                out.setdefault("encoder_pair_forward", {})[f"{key}_minibatch_ms"] = pair_ms
                out.setdefault("encoder_backward", {})[f"{key}_ms"] = bwd_ms
                out.setdefault("pair_forward_loss", {})[f"{key}_ms"] = ms9
                out.setdefault("pair_forward_loss_agrad", {})[f"{key}_ms"] = ms10
    # the smaller spec after the larger, then the larger again: the forward's
    # shared-memory attribute never drops below a spec's carve
    gen = tile_gen
    for groups in (TOK7_GROUPS, WIDE_GROUPS, GROUPS, WIDE_GROUPS, TOK16_GROUPS, GROUPS,
                   TOK16_GROUPS, LIMIT_GROUPS, GROUPS):
        spec_a = fe.EncoderSpec(groups=groups, head_dim=4)
        la = random_leaves(fe.leaf_shapes(spec_a), gen, dev)
        x = (2.0 * torch.randn((4099, spec_a.obs_dim), generator=gen)).to(dev)
        compare(f"encoder_forward {spec_a.n_tokens} tokens S=4099, after another spec",
                fe.encoder_forward(spec_a, la, x), fe.reference_apply(spec_a, la, x),
                fe.KERNEL_TOL, in_f64(fe.reference_apply, spec_a, la, x))
    return out


def _all_finite(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return bool(torch.isfinite(tree).all())
    return all(_all_finite(v) for v in tree.values())


def make_slice(dev, num_envs, max_episode_length, **algo):
    """bench.py's HideAndSeek and MAPPO configuration (TP net on) on `dev`;
    `algo` overrides MAPPOCfg fields."""
    from mupe_tpu_torch.envs import HideAndSeek, HideAndSeekCfg
    from mupe_tpu_torch.learning import MAPPOCfg, MAPPOPolicy

    env = HideAndSeek(HideAndSeekCfg(num_envs=num_envs,
                                     max_episode_length=max_episode_length), device=dev)
    policy = MAPPOPolicy(MAPPOCfg(train_every=STEPS, use_tp_net=True, **algo), n_agents=3,
                         action_dim=4, obs_is_dict=True,
                         tp_input_dim=env.cfg.tp_input_dim, device=dev)
    return env, policy


def check_against_cpu(dev) -> None:
    """The card's path (kernels) against the CPU path (plain versions) on
    16 arenas for 8 deterministic steps, from the same state and weights
    (heads scaled from their 0.01 initial gain to 1).
    Free-running, so kernel rounding carries from step to step: values and
    actions within 3e-2 of their scale, observations and rewards within
    1e-2 (a collision or capture flip would cost 20 or more)."""
    from mupe_tpu_torch.envs import tree_to
    from mupe_tpu_torch.learning import init_carry, make_rollout

    env_c, pol_c = make_slice("cpu", 16, 800)
    env_g, pol_g = make_slice(dev, 16, 800)
    state = env_c.reset(torch.Generator().manual_seed(7))
    template = {k: torch.zeros((1,) + s) for k, s in env_c.obs_groups().items()}
    ts_c = pol_c.init(template, torch.Generator().manual_seed(8))
    ts_g = pol_g.init(template, torch.Generator().manual_seed(8))  # the same weights
    with torch.no_grad():  # heads at unit gain: O(1) actions that drive the drones
        for ts in (ts_c, ts_g):
            ts.actor.leaves[-2].mul_(100.0)
            ts.critic.leaves[-2].mul_(100.0)
    carry_c = init_carry(env_c, pol_c, torch.Generator().manual_seed(9), ts_c, state)
    carry_g = init_carry(env_g, pol_g, torch.Generator(device=dev).manual_seed(9), ts_g,
                         tree_to(state, dev))
    _, traj_c, _ = make_rollout(env_c, pol_c, deterministic=True)(carry_c, 8)
    _, traj_g, _ = make_rollout(env_g, pol_g, deterministic=True)(carry_g, 8)
    traj_g = tree_to(traj_g, "cpu")
    for key, rel in (("value", 3e-2), ("action", 3e-2)):
        err = (traj_g[key] - traj_c[key]).abs().max().item()
        scale = traj_c[key].abs().max().item()
        log(f"  card vs CPU {key}: max_abs_err={err:.3e} (scale {scale:.3e}, tol {rel}·scale)")
        if not err <= rel * scale:
            raise AssertionError(f"card and CPU rollouts disagree on {key}")
    for key in ("reward", "tp_input"):
        err = (traj_g[key] - traj_c[key]).abs().max().item()
        log(f"  card vs CPU {key}: max_abs_err={err:.3e} (tol 1e-2)")
        if not err <= 1e-2:
            raise AssertionError(f"card and CPU rollouts disagree on {key}")
    for key, v in traj_c["obs"].items():
        err = (traj_g["obs"][key] - v).abs().max().item()
        log(f"  card vs CPU obs[{key}]: max_abs_err={err:.3e} (tol 1e-2)")
        if not err <= 1e-2:
            raise AssertionError(f"card and CPU rollouts disagree on obs[{key}]")
    if not torch.equal(traj_g["done"], traj_c["done"]):
        raise AssertionError("card and CPU rollouts disagree on done")


def phase_slice(dev, card: str) -> None:
    from mupe_tpu_torch.envs.hideandseek import STAT_KEYS
    from mupe_tpu_torch.learning import init_carry, make_rollout
    from mupe_tpu_torch.ops import fused_encoder as fe
    from mupe_tpu_torch.ops import tp_lstm as tl

    log(f"[3] slice: HideAndSeek {NUM_ENVS} arenas x {STEPS} steps, MAPPO act + TP net")
    env, policy = make_slice(dev, NUM_ENVS, 800)
    t0 = time.perf_counter()
    carry = init_carry(env, policy, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"  init_carry (reset + scene sampling + first observation): "
        f"{time.perf_counter() - t0:.3f} s")
    rollout = make_rollout(env, policy)
    wrappers = {"encoder_pair_forward": fe.encoder_pair_forward,
                "encoder_forward": fe.encoder_forward, "tp_forward": tl.tp_forward}
    for fn in wrappers.values():
        fn.launches = 0
    for _ in range(WARMUP_ROLLOUTS):
        carry, traj, ep_stats = rollout(carry)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_ROLLOUTS):
        carry, traj, ep_stats = rollout(carry)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    value = policy.value_op(carry.ts, carry.obs)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log(f"  launches over {WARMUP_ROLLOUTS + TIMED_ROLLOUTS} rollouts + value_op: {launches}")
    rollouts = WARMUP_ROLLOUTS + TIMED_ROLLOUTS
    if (launches["encoder_pair_forward"] < STEPS * rollouts
            or launches["tp_forward"] < STEPS * rollouts
            or launches["encoder_forward"] < 1):
        raise AssertionError(f"the main path skipped a kernel: {launches}")
    shapes = {"value": (STEPS, NUM_ENVS, 3, 1), "reward": (STEPS, NUM_ENVS, 3, 1),
              "done": (STEPS, NUM_ENVS, 1), "action": (STEPS, NUM_ENVS, 3, 4),
              "logp": (STEPS, NUM_ENVS, 3, 1), "tp_input": (STEPS, NUM_ENVS, 10, 16),
              "tp_gt": (STEPS, NUM_ENVS, 3), "tp_done": (STEPS, NUM_ENVS, 1)}
    for key, shape in shapes.items():
        if tuple(traj[key].shape) != shape:
            raise AssertionError(f"traj[{key}] has shape {tuple(traj[key].shape)}, want {shape}")
    if tuple(value.shape) != (NUM_ENVS, 3, 1):
        raise AssertionError(f"value_op shape {tuple(value.shape)}")
    if not (_all_finite(traj) and _all_finite(ep_stats) and _all_finite(value)
            and _all_finite(carry.obs)):
        raise AssertionError("non-finite output in the slice")
    if set(ep_stats) != set(STAT_KEYS) | {"episode_count"}:
        raise AssertionError(f"ep_stats keys {sorted(ep_stats)}")
    steps_per_s = NUM_ENVS * STEPS * TIMED_ROLLOUTS / seconds
    log(f"  rollout: {NUM_ENVS} x {STEPS} x {TIMED_ROLLOUTS} env-steps in {seconds:.4f} s "
        f"= {steps_per_s:.1f} env-steps/s ({seconds / TIMED_ROLLOUTS * 1e3:.2f} ms per "
        f"rollout) on {card}")

    log("  short episodes (max_episode_length=8): auto-reset and scene sampling on the card")
    env8, policy8 = make_slice(dev, NUM_ENVS, 8)
    carry8 = init_carry(env8, policy8, torch.Generator(device=dev).manual_seed(1))
    _, traj8, ep8 = make_rollout(env8, policy8)(carry8, 20)
    torch.cuda.synchronize()
    done_steps = traj8["done"][:, :, 0].all(dim=1).nonzero().flatten().tolist()
    if done_steps != [7, 15] or float(ep8["episode_count"]) != 2 * NUM_ENVS:
        raise AssertionError(f"resets at steps {done_steps}, episodes {ep8['episode_count']}")
    if not (_all_finite(traj8) and _all_finite(ep8)):
        raise AssertionError("non-finite output after auto-reset")
    log(f"  resets at steps {done_steps}; episodes {int(ep8['episode_count'])}; "
        f"success {float(ep8['success']):.4f}, scene_fallback {float(ep8['scene_fallback']):.4f}")
    check_against_cpu(dev)


def check_update_against_cpu(dev, env_kw=None, **algo) -> None:
    """The update on the card (kernels) against the update on the CPU (plain
    versions): one `train_op` at 16 arenas x 8 steps, 2 minibatches, 1
    epoch, from the same state and weights, on the same trajectory (a CPU
    rollout, copied to the card) with the same permutation.  Metrics within
    5e-3 relative, the forward kernel's largest error against its plain
    version (heads at unit gain, so the loss's every term moves; measured
    2.4e-3 on policy_loss on an H100), 1e-2 for the gradient norms (the
    kernel's gradients part from the plain version's by its tolerance);
    parameters within 3e-3 absolute (two Adam steps of about lr = 5e-4).
    `algo` overrides MAPPOCfg fields (the in-kernel loss's), `env_kw`
    HideAndSeekCfg fields (then 16 steps, or 6 past the predicted ones); the
    card's update must launch the loss kernel of its `direct_mode` once a
    minibatch and the other one never."""
    from mupe_tpu_torch.envs import HideAndSeek, HideAndSeekCfg, tree_to
    from mupe_tpu_torch.learning import MAPPOCfg, MAPPOPolicy, init_carry, make_rollout
    from mupe_tpu_torch.ops import fused_encoder as fe

    env_kw = env_kw or {}
    env_c = HideAndSeek(HideAndSeekCfg(num_envs=16, max_episode_length=800, **env_kw),
                        device="cpu")
    steps = max(16, env_c.cfg.future_prediction_step + 6) if env_kw else 8
    cfg = MAPPOCfg(train_every=steps, num_minibatches=2, ppo_epochs=1, use_tp_net=True,
                   future_prediction_step=env_c.cfg.future_prediction_step, **algo)
    pols = {d: MAPPOPolicy(cfg, n_agents=env_c.num_agents, action_dim=4, obs_is_dict=True,
                           tp_input_dim=env_c.cfg.tp_input_dim, device=d,
                           tp_history_step=env_c.cfg.history_step) for d in ("cpu", dev)}
    template = {k: torch.zeros((1,) + s) for k, s in env_c.obs_groups().items()}
    ts = {d: p.init(template, torch.Generator().manual_seed(8)) for d, p in pols.items()}
    with torch.no_grad():  # heads at unit gain: the loss's every term moves
        for t in ts.values():
            t.actor.leaves[-2].mul_(100.0)
            t.critic.leaves[-2].mul_(100.0)
    carry = init_carry(env_c, pols["cpu"], torch.Generator().manual_seed(9), ts["cpu"])
    carry, traj, _ = make_rollout(env_c, pols["cpu"])(carry)
    perms = torch.randperm(16 * steps, generator=torch.Generator().manual_seed(10))[None]
    out = {}
    loss_kernels = {"fwdloss": fe.pair_forward_loss, "agrad": fe.pair_forward_loss_agrad}
    before = {m: fn.launches for m, fn in loss_kernels.items()}
    for d, pol in pols.items():
        state, metrics = pol.train_op(ts[d], tree_to(traj, d), tree_to(carry.obs, d), perms=perms)
        out[d] = (state, {k: float(v) for k, v in metrics.items()})
    took = {m: fn.launches - before[m] for m, fn in loss_kernels.items()}
    want = {m: cfg.num_minibatches if cfg.use_inkernel_loss and m == cfg.direct_mode else 0
            for m in loss_kernels}
    if took != want:
        raise AssertionError(f"loss-kernel launches in the card's update {took}, want {want}")
    (ts_c, m_c), (ts_g, m_g) = out["cpu"], out[dev]
    worst = max((abs(m_g[k] - m_c[k]) / max(abs(m_c[k]), 1e-5), k) for k in m_c)
    log(f"  card vs CPU update metrics: worst relative difference {worst[0]:.3e} ({worst[1]})")
    for k, v in m_c.items():
        rel = 1e-2 if k.endswith("grad_norm") else 5e-3
        if not abs(m_g[k] - v) <= rel * abs(v) + 1e-5:
            raise AssertionError(f"card and CPU updates disagree on {k}: {m_g[k]} vs {v}")
    groups = {"actor": [(ts_g.actor.flat, ts_c.actor.flat), (ts_g.log_std, ts_c.log_std)],
              "critic": [(ts_g.critic.flat, ts_c.critic.flat)],
              "tp": list(zip(ts_g.tp_net.leaves(), ts_c.tp_net.leaves()))}
    errs = {name: max((g.detach().cpu() - c.detach()).abs().max().item() for g, c in pairs)
            for name, pairs in groups.items()}
    err = max(errs.values())
    log(f"  card vs CPU parameters after the update: max_abs_err={err:.3e} (tol 3e-3; "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + ")")
    if not err <= 3e-3:
        raise AssertionError("card and CPU updates disagree on the parameters")


def run_train_iters(train_iter, carry):
    """WARMUP_ITERS + TIMED_ITERS iterations, then a further one with the
    phase boundaries synchronised, for the split.  Returns (carry, metrics,
    ep_stats, seconds of the timed iterations, {phase: seconds})."""
    for _ in range(WARMUP_ITERS):
        carry, metrics, ep_stats = train_iter(carry)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_ITERS):
        carry, metrics, ep_stats = train_iter(carry)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    split, last = {}, [time.perf_counter()]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        split[name] = split.get(name, 0.0) + now - last[0]
        last[0] = now

    carry, metrics, ep_stats = train_iter(carry, mark=mark)
    return carry, metrics, ep_stats, seconds, split


def check_train_outputs(carry, metrics, ep_stats) -> None:
    """The metrics' keys, and every metric, stat and parameter finite."""
    if set(metrics) != METRIC_KEYS:
        raise AssertionError(f"metrics keys {sorted(metrics)}")
    if not (_all_finite(metrics) and _all_finite(ep_stats)
            and all(bool(torch.isfinite(p).all()) for p in
                    (carry.ts.actor.flat, carry.ts.log_std, carry.ts.critic.flat))):
        raise AssertionError("non-finite metric or parameter after training")
    log("  metrics: " + ", ".join(f"{k}={float(v):.5g}" for k, v in sorted(metrics.items())))


def phase_train(dev, card: str):
    from mupe_tpu_torch.learning import init_carry, make_train_iter
    from mupe_tpu_torch.ops import fused_encoder as fe
    from mupe_tpu_torch.ops import tp_lstm as tl

    log(f"[4] training: make_train_iter, HideAndSeek {NUM_ENVS} arenas x {STEPS} steps, "
        f"bench.py's MAPPOCfg (16 minibatches, 4 PPO epochs, TP net)")
    env, policy = make_slice(dev, NUM_ENVS, 800)
    carry = init_carry(env, policy, torch.Generator(device=dev).manual_seed(2))
    train_iter = make_train_iter(env, policy)
    wrappers = {"encoder_pair_forward": fe.encoder_pair_forward,
                "encoder_forward": fe.encoder_forward, "tp_forward": tl.tp_forward,
                "encoder_backward": fe.encoder_backward, "weight_grads": fe.weight_grads,
                "tp_backward": tl.tp_backward, "tp_weight_grads": tl.tp_weight_grads}
    for fn in wrappers.values():
        fn.launches = 0
    carry, metrics, ep_stats, seconds, split = run_train_iters(train_iter, carry)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    iters = WARMUP_ITERS + TIMED_ITERS + 1
    log(f"  launches over {iters} iterations: {launches} (weight_grads: the encoder "
        f"backward's stage B, one launch a backward; tp_weight_grads the TP backward's, one a "
        f"chunk of windows)")
    if (launches["encoder_backward"] < 64 * iters or launches["tp_backward"] < iters
            or launches["tp_weight_grads"] != launches["tp_backward"]
            or launches["weight_grads"] != launches["encoder_backward"]
            or launches["encoder_pair_forward"] < 128 * iters
            or launches["encoder_forward"] < iters or launches["tp_forward"] < 65 * iters):
        raise AssertionError(f"the training path skipped a kernel: {launches}")
    check_train_outputs(carry, metrics, ep_stats)
    rate = NUM_ENVS * STEPS * TIMED_ITERS / seconds
    log(f"  training: {NUM_ENVS} x {STEPS} x {TIMED_ITERS} env-steps in {seconds:.4f} s "
        f"= {rate:.1f} env-steps/s ({seconds / TIMED_ITERS * 1e3:.2f} ms per iteration) "
        f"on {card}")
    log("  one iteration, phases synchronised: " + ", ".join(
        f"{k} {v * 1e3:.2f} ms" for k, v in split.items()))
    check_update_against_cpu(dev)
    return launches, rate


def _equal_trees(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal_trees(u, v) for u, v in zip(a, b))
    return a == b


def check_update_history_against_cpu(dev, gen_saved: dict) -> None:
    """`update_history` on the card (the FPS kernel) against the CPU (the
    plain FPS) from the same buffer state: the trained run's buffer and
    eval tasks with 3 episodes of success drawn per arena.  The history
    must be the same bits."""
    from mupe_tpu_torch.envs import GenBufferState, tree_to
    from mupe_tpu_torch.envs.genbuffer import update_history

    g = torch.Generator().manual_seed(11)
    gb = GenBufferState(**gen_saved)
    gb.weight_sum = torch.randint(0, 4, gb.weight_sum.shape, generator=g).to(torch.float32)
    gb.weight_count = torch.tensor(3, dtype=torch.int32)
    t0 = time.perf_counter()
    cpu, added_c = update_history(gb, 0.0, 0.9)
    cpu_s = time.perf_counter() - t0
    card, added_g = update_history(tree_to(gb, dev), 0.0, 0.9)
    card = tree_to(card, "cpu")
    log(f"  update_history card vs CPU: {int(added_g)} vs {int(added_c)} added, history_len "
        f"{int(card.history_len)} vs {int(cpu.history_len)}, history bit-identical: "
        f"{torch.equal(card.history, cpu.history)} (the CPU's plain FPS took {cpu_s:.2f} s)")
    if not (int(added_g) == int(added_c) and int(card.history_len) == int(cpu.history_len)
            and torch.equal(card.history, cpu.history)):
        raise AssertionError("update_history on the card disagrees with the CPU")


def phase_aeg(dev, card: str) -> dict:
    """AEG training through the port's entry point: `harness.train` with task
    HideAndSeek_envgen at 4096 arenas, a 5000-task buffer and the TP net,
    bench.py's MAPPOCfg.  Cut so that cycles close inside the run:
    max_episode_length 16 (a 3-episode cycle closes inside one 64-step
    iteration) and the buffer full from the easy cases with r_min = 0 (every
    cycle overflows it and downsamples by FPS)."""
    from mupe_tpu_torch import harness
    from mupe_tpu_torch.envs.hideandseek_envgen import envgen_extra_stats
    from mupe_tpu_torch.learning import init_carry
    from mupe_tpu_torch.ops import fps
    from mupe_tpu_torch.ops import fused_encoder as fe
    from mupe_tpu_torch.ops import tp_lstm as tl
    from mupe_tpu_torch.utils.checkpoint import load_checkpoint, to_plain
    from mupe_tpu_torch.utils.config import parse_cli

    iters = WARMUP_ITERS + TIMED_ITERS
    log(f"[5] AEG training: harness.train task=HideAndSeek_envgen, {NUM_ENVS} arenas x {STEPS} "
        f"steps, buffer {AEG_BUFFER}, TP net; cuts: max_episode_length={AEG_EPISODE}, "
        f"use_init_easy_cases with r_min=0")
    wrappers = {"encoder_pair_forward": fe.encoder_pair_forward,
                "encoder_forward": fe.encoder_forward, "tp_forward": tl.tp_forward,
                "encoder_backward": fe.encoder_backward, "weight_grads": fe.weight_grads,
                "tp_backward": tl.tp_backward,
                "farthest_point_sampling": fps.farthest_point_sampling}
    with tempfile.TemporaryDirectory() as run_dir:
        argv = [f"env.num_envs={NUM_ENVS}", f"env.max_episode_length={AEG_EPISODE}",
                f"env.buffer_length={AEG_BUFFER}", "env.use_init_easy_cases=true",
                "env.r_min=0.0", f"algo.train_every={STEPS}", f"max_iters={iters}",
                "log_interval=1", "save_interval=-1", f"run_dir={run_dir}", "run_name=aeg",
                "seed=3"]
        for fn in wrappers.values():
            fn.launches = 0
        metrics = harness.train(argv, default_task="HideAndSeek_envgen", device=dev)
        launches = {name: fn.launches for name, fn in wrappers.items()}
        log(f"  launches over {iters} iterations: {launches}")
        cycles = (iters * STEPS // AEG_EPISODE) // 3
        if launches["farthest_point_sampling"] < 1 or any(v < 1 for v in launches.values()):
            raise AssertionError(f"the AEG path skipped a kernel: {launches}")
        log(f"  FPS launches {launches['farthest_point_sampling']} for {cycles} closed cycles")
        with open(Path(run_dir) / "aeg" / "metrics.csv") as f:
            rows = list(csv.DictReader(f))
        frames = NUM_ENVS * STEPS
        seconds = sum(frames / float(r["rollout_fps"]) for r in rows[WARMUP_ITERS:])
        rate = frames * TIMED_ITERS / seconds
        missing = [k for k in METRIC_KEYS | {f"stats/{k}" for k in
                                             envgen_extra_stats(5)} if k not in metrics]
        if missing or not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"AEG training: missing {missing} or non-finite metrics")
        log("  AEG stats: " + ", ".join(f"{k}={metrics[f'stats/{k}']:.5g}"
                                         for k in envgen_extra_stats(5)[:4]))
        full = Path(run_dir) / "aeg" / "checkpoints" / "full"
        saved = load_checkpoint(full)
        hist_len = int(saved["env_state"]["gen"]["history_len"])
        if hist_len != AEG_BUFFER:
            raise AssertionError(f"history_buffer {hist_len} after a cycle, want {AEG_BUFFER}")
        sections, _ = parse_cli(argv)
        env, policy, _, _ = harness.build("HideAndSeek_envgen", sections["env"],
                                          sections["algo"], device=dev)
        restored = load_checkpoint(full, target=init_carry(
            env, policy, torch.Generator(device=dev).manual_seed(0)))
        if not _equal_trees(to_plain(restored), saved):
            raise AssertionError("the full checkpoint did not read back equal")
        log(f"  checkpoint {full.name}/step_{iters} written and read back equal; "
            f"history_buffer {hist_len}")
    log(f"  AEG training: {NUM_ENVS} x {STEPS} x {TIMED_ITERS} env-steps in {seconds:.4f} s "
        f"= {rate:.1f} env-steps/s ({seconds / TIMED_ITERS * 1e3:.2f} ms per iteration, "
        f"harness log rows {WARMUP_ITERS + 1}-{iters}) on {card}")
    check_update_history_against_cpu(dev, saved["env_state"]["gen"])
    return launches


def phase_inkernel(dev, card: str, rate4: float) -> dict:
    """Training with the in-kernel loss (`use_inkernel_loss=True`) at phase
    4's configuration, in each `direct_mode`.  Returns each loss kernel's
    launches over the run of its mode."""
    from mupe_tpu_torch.learning import init_carry, make_train_iter
    from mupe_tpu_torch.ops import fused_encoder as fe
    from mupe_tpu_torch.ops import tp_lstm as tl

    iters = WARMUP_ITERS + TIMED_ITERS + 1
    wrappers = {"pair_forward_loss": fe.pair_forward_loss,
                "pair_forward_loss_agrad": fe.pair_forward_loss_agrad,
                "encoder_backward": fe.encoder_backward, "weight_grads": fe.weight_grads,
                "encoder_pair_forward": fe.encoder_pair_forward,
                "encoder_forward": fe.encoder_forward, "tp_forward": tl.tp_forward,
                "tp_backward": tl.tp_backward}
    kernel = {"fwdloss": "pair_forward_loss", "agrad": "pair_forward_loss_agrad"}
    minibatches = 16 * 4
    out = {}
    for mode in ("fwdloss", "agrad"):
        log(f"[6] in-kernel-loss training, direct_mode={mode!r}: make_train_iter, phase 4's "
            f"configuration with use_inkernel_loss=True")
        env, policy = make_slice(dev, NUM_ENVS, 800, use_inkernel_loss=True, direct_mode=mode)
        carry = init_carry(env, policy, torch.Generator(device=dev).manual_seed(4))
        train_iter = make_train_iter(env, policy)
        for fn in wrappers.values():
            fn.launches = 0
        carry, metrics, ep_stats, seconds, split = run_train_iters(train_iter, carry)
        launches = {name: fn.launches for name, fn in wrappers.items()}
        log(f"  launches over {iters} iterations: {launches}")
        want = {kernel[mode]: minibatches * iters, "encoder_backward": minibatches * iters,
                "encoder_pair_forward": STEPS * iters,
                kernel["agrad" if mode == "fwdloss" else "fwdloss"]: 0,
                "weight_grads": minibatches * iters * (2 if mode == "agrad" else 1)}
        if (any(launches[k] != v for k, v in want.items()) or launches["encoder_forward"] < iters
                or launches["tp_forward"] < (STEPS + 1) * iters or launches["tp_backward"] < iters):
            raise AssertionError(f"launches {launches}, want {want} (64 loss-kernel launches "
                                 f"and 64 backwards an iteration, each with its stage B, pair "
                                 f"forwards only from acting)")
        check_train_outputs(carry, metrics, ep_stats)
        rate = NUM_ENVS * STEPS * TIMED_ITERS / seconds
        log(f"  training ({mode}): {NUM_ENVS} x {STEPS} x {TIMED_ITERS} env-steps in "
            f"{seconds:.4f} s = {rate:.1f} env-steps/s ({seconds / TIMED_ITERS * 1e3:.2f} ms per "
            f"iteration) against phase 4's {rate4:.1f} on {card}")
        log("  one iteration, phases synchronised: " + ", ".join(
            f"{k} {v * 1e3:.2f} ms" for k, v in split.items()))
        check_update_against_cpu(dev, use_inkernel_loss=True, direct_mode=mode)
        out[kernel[mode]] = launches[kernel[mode]]
        if mode == "agrad":  # its stage B (and the critic backward's)
            out[f"{kernel[mode]}:stage_b"] = launches["weight_grads"]
    return out


def phase_config_train(dev, card: str, phase: int, label: str, env_kw: dict, modes) -> None:
    """Training at another HideAndSeek configuration through `harness.build`
    (as `python -m mupe_tpu_torch.train env.<field>=<value> ...` builds it),
    at WIDE_NUM_ENVS arenas: 2 iterations in each of `modes` (None: the
    default update; "fwdloss", "agrad": the in-kernel loss); the launch
    counts, finite outputs and the update on the card against the CPU for
    each."""
    from mupe_tpu_torch import harness
    from mupe_tpu_torch.learning import init_carry, make_train_iter
    from mupe_tpu_torch.ops import fused_encoder as fe
    from mupe_tpu_torch.ops import tp_lstm as tl

    wrappers = {"encoder_pair_forward": fe.encoder_pair_forward,
                "encoder_forward": fe.encoder_forward, "tp_forward": tl.tp_forward,
                "encoder_backward": fe.encoder_backward, "weight_grads": fe.weight_grads,
                "tp_backward": tl.tp_backward, "tp_weight_grads": tl.tp_weight_grads,
                "pair_forward_loss": fe.pair_forward_loss,
                "pair_forward_loss_agrad": fe.pair_forward_loss_agrad}
    update = {None: "encoder_pair_forward", "fwdloss": "pair_forward_loss",
              "agrad": "pair_forward_loss_agrad"}
    for mode in modes:
        algo = {"use_inkernel_loss": True, "direct_mode": mode} if mode else {}
        log(f"[{phase}] {label} training: HideAndSeekCfg({env_kw}), {WIDE_NUM_ENVS} arenas x "
            f"{STEPS} steps, MAPPOCfg overrides {algo or 'none'}")
        env, policy, env_cfg, _ = harness.build(
            "HideAndSeek", dict(env_kw, num_envs=WIDE_NUM_ENVS), dict(algo, train_every=STEPS),
            device=dev)
        _, spec_a, _ = policy.specs({k: torch.zeros((1,) + v)
                                     for k, v in env.obs_groups().items()})
        log(f"  observation groups {spec_a.groups} ({spec_a.n_tokens} tokens, "
            f"{spec_a.obs_dim} columns), TP input {env_cfg.tp_input_dim}, TP output "
            f"{3 * env_cfg.future_prediction_step}")
        carry = init_carry(env, policy, torch.Generator(device=dev).manual_seed(5))
        train_iter = make_train_iter(env, policy)
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            carry, metrics, ep_stats = train_iter(carry)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
        log(f"  launches over 2 iterations: {launches}")
        if (launches["encoder_backward"] < 2 * 64 or launches["tp_backward"] < 2
                or launches["tp_weight_grads"] != launches["tp_backward"]
                or launches[update[mode]] < 2 * 64 or launches["tp_forward"] < 2 * (STEPS + 1)):
            raise AssertionError(f"the {label} configuration skipped a kernel: {launches}")
        check_train_outputs(carry, metrics, ep_stats)
        log(f"  {label} training: {WIDE_NUM_ENVS} x {STEPS} x 2 env-steps in {seconds:.4f} s "
            f"(first iterations, compile and warm-up included) on {card}")
        check_update_against_cpu(dev, env_kw=env_kw, **algo)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    card = card_line()
    log(f"[0] card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    phase_build()
    kernels = phase_kernels(dev)
    phase_slice(dev, card)
    launches, rate = phase_train(dev, card)
    launches["farthest_point_sampling"] = phase_aeg(dev, card)["farthest_point_sampling"]
    launches.update(phase_inkernel(dev, card, rate))
    phase_config_train(dev, card, 7, "wide-configuration", WIDE_ENV, (None, "agrad"))
    phase_config_train(dev, card, 8, "16-token", TOK16_ENV, (None, "fwdloss", "agrad"))
    phase_config_train(dev, card, 9, "past-the-tile-limits", LIMIT_ENV,
                       (None, "fwdloss", "agrad"))
    launches["encoder_backward:stage_b"] = launches["weight_grads"]
    launches["tp_backward:stage_b"] = launches["tp_weight_grads"]
    summary = {"kernels": [
        dict(name=name, launches=launches[name], **info,
             **({"stage_b_launches": launches[f"{name}:stage_b"]}
                if f"{name}:stage_b" in launches else {}))
        for name, info in kernels.items()
    ]}
    log(f"wall time {time.perf_counter() - t0:.1f} s")
    log(card)
    log(json.dumps(summary))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
