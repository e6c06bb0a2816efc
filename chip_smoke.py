#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port's main path (one GPU).

    python3 chip_smoke.py

Phases, each of which raises on failure (so any failure exits non-zero):

0. require a CUDA card; print its name and power limit (nvidia-smi);
1. build the CUDA kernels from mupe_tpu_torch/csrc/ with nvcc (timed);
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, and time both with CUDA events;
3. the slice: HideAndSeek (4096 arenas, 3 pursuers, random cylinders, TP
   net) with MAPPO acting, ITERS rollouts of 64 steps, then the bootstrap
   value; checks launch counts, finiteness, the episode-stat keys and
   agreement with the CPU path on a small input; and a short rollout with
   8-step episodes so auto-reset and scene sampling run;
4. training: `make_train_iter` (rollout + the MAPPO and TP-net update) at
   bench.py's configuration, ITERS iterations; checks launch counts, the
   metrics' keys and finiteness, and the update on the card against the
   update on the CPU from the same state and trajectory; then one iteration
   whose rollout replays its CUDA graphs against one through the eager
   segments, from twins of the carry (the same bits in every output, the
   parameters and the generator after it), and prints the graphed one's
   replay share;
5. AEG training: `harness.train` with task HideAndSeek_envgen (4096 arenas,
   a 5000-task buffer, TP net), ITERS iterations; checks that closed cycles
   took the FPS kernel, the buffer, the AEG stats, the update,
   `update_history` on the card against the CPU, and a checkpoint written
   and read back;
6. in-kernel-loss training: phase 4's configuration with
   `use_inkernel_loss=True`, once with `direct_mode="fwdloss"` and once with
   "agrad", ITERS iterations each; checks each mode's launch counts (64
   loss-kernel launches an iteration, no pair forward from the update), the
   metrics and the update on the card against the CPU;
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
10. evaluation and the rest of the harness: README's composed recipe
   (`train_generator`'s defaults with use_init_easy_cases, max_cylinders 6,
   eval_spawn_ratio 0.3, eval_scenario_ratio 0.25, starve_cycles 8,
   starve_ratio_unif 0.7, entropy_target 1.2) through `harness.train` at
   4096 arenas for 5 iterations, cut as phase 5, with an evaluation episode
   every iteration, the NaN guard and a profiler trace of iterations 1-3
   (checks the eval rows, that the trace names the pair forward's kernel,
   the FPS launches and the mixing fractions of its scene sampler); then
   `harness.evaluate` from its checkpoint at 4096 arenas on the wall
   scenario in eval mode, 800-step greedy episodes (every episode ends,
   every stat finite, one pair forward and one TP forward a step), and
   once over random cylinders with jitter (4096
   distinct scenes); the card's evaluation against the CPU's (16 arenas,
   32 steps, phase 3's limits); and the NaN guard restoring a poisoned
   iteration's carry bit for bit, CUDA generator included.
11. Hover and MAPPO's flat observations (no kernel: the flat MLPs are plain
   torch on the card, as the JAX package's flat path is plain XLA): (a)
   the card's env step, actor mean and critic value against the CPU's,
   teacher-forced (each step the card steps the CPU's state with the CPU's
   action and draws) at 16 arenas x 32 steps with two auto-resets, with
   every sim2real option on and with domain randomization + payload; the
   pos_error / head_error <= 0.02 bonus flips are counted, each must sit
   at its threshold; (b) one `train_op` on the card against the CPU from the
   same weights, trajectory and permutations; (c) training the drive
   recipe's configuration (`HoverCfg(num_envs=1024, max_episode_length=300)`,
   `MAPPOCfg(train_every=32, num_minibatches=8)`, hidden (256, 256, 256),
   bf16) for about HOVER_SECONDS and at least HOVER_MIN_ITERS iterations:
   the iteration count and the mean pos_error (the arenas' distance to the
   target at an iteration's end) of the first and last 10 iterations (the
   last must sit below the first; every value finite), and the episode-end
   pos_error stat of the iterations that ended episodes.
12. MAPPO's options and the PPO family: (a) rows 2 and 5 (`encoder_forward`,
   `encoder_backward`) against their plain versions with the f32 controls
   and timed, at a per-agent actor's 16,384 rows, the critic's 49,152 and
   the state critic's 16,384 (HideAndSeek's state widths, a head of 3);
   (b) at bench.py's width, `share_actor=False`: OPT_ITERS iterations
   (launches an iteration of rows 2, 3, 5 and 6, each agent's actor and the
   critic one launch each), one `train_op` card vs CPU; the relation
   encoders and `algo=transformer`, OPT_ITERS iterations each,
   finite; `critic_input="state"` on HideAndSeek refused with a ValueError,
   as the JAX package fails; the state critic at policy level over
   HideAndSeek's real observations and a well-formed state (its cylinders
   cut to [E, k, 5]): act card vs CPU on 4,096 arenas, one `train_op` on the
   card (its launches counted) and one card vs CPU on 64 arenas x 64 steps;
   (c) Hover at the drive recipe's width (1,024 x 32): ppo, ppo with the
   privileged branches, ppo_tconv and ppo_rnn, 2 iterations each, finite,
   and one act and one `train_op` each card vs CPU, teacher-forced at 16
   arenas; ppo_sdf at policy level, 4,096 rows x 64 points, card vs CPU.
13. the rest of the registry (no kernel: JAX's ppo_adapt and ppo_vision
   reach no `pallas_call`; the phase checks that every kernel's count stays
   0): ppo_vision on Hover's depth camera (32 x 24) at Hover's default 4,096
   arenas x 32 steps, 8 minibatches, with the conv backbone and with
   MobileNetV3-Small, VISION_ITERS iterations each (finite), and one act and
   one `train_op` each card vs CPU at 16 arenas (phase 11's bounds);
   MobileNetV3-Large forward + backward on one update minibatch (16,384
   frames), card vs CPU within 2x the CPU float32's own error against the
   card's float64; Hover's depth frame at 4,096 arenas and `depth_image`
   with the wall, the ceiling, 6 cylinders and the target at 4,096 cameras
   of 64 x 48, card vs CPU, at most 1e-4 of the pixels (grazing rays) past
   1e-5; RMA through `train` (`task=Hover algo=ppo_adapt max_iters=8` on
   the card: the last row phase 3, every logged value finite) and
   `update_adaptation` card vs CPU for each of
   its six losses on one phase-2 batch of 4,096 x 32 rows; the trajectory
   ring buffer (L = 128, E = 4,096, extended past its seam, 4,096 windows of
   16 steps) identical card vs CPU.
14. data parallelism over the arena axis (`mupe_tpu_torch/parallel`), in
   worker processes (`chip_smoke.py --dp-worker ...`; this process holds no
   process group) at bench.py's width (4,096 arenas x 64 steps, TP net):
   world size 1 over NCCL through `harness.train`, 2 iterations, the
   learner's bits equal to the run without a group; two ranks sharing the
   card over gloo (CUDA tensors, 2,048 arenas each), one iteration on the
   default path and in each `direct_mode`, the ranks' learners
   bit-identical (an all-gathered digest), the joined trajectory, the
   first gradients and the learner held against the one rank's same
   iteration; AEG at 2 ranks (phase 5's cuts) through one closed cycle,
   the buffer's bits equal on the ranks, each rank an FPS launch; and
   Hover's flat MAPPO at 2 ranks through `harness.train`.
15. the PPO family across ranks, in worker processes (`--dp-worker
   fam1|fam2`): world size 1 over NCCL through `harness.train` for ppo_rnn
   and transformer at 4,096 arenas (2 iterations of 16 steps), the learner's
   bits equal to the run without a group; two ranks sharing the card over
   gloo, one iteration each of ppo, privileged ppo, ppo_tconv, ppo_rnn,
   transformer and ppo_vision (conv) at 1,024 x 32 and ppo_vision with
   MobileNetV3-Small at 256 arenas, held as in phase 14, no kernel launched;
   the Lee (Firefly, Hummingbird, the Crazyflie at its hover state),
   attitude, rate and DSL PID controllers, Dragon (300 steps with gimbal and
   joint commands) and the transport group (the demo's 900-tick ramp) at
   4,096 arenas, each held against the CPU's first 64 arenas and to the JAX
   tests' physical checks; every `mupe_tpu_torch.examples` module run on
   the card, exit 0.
16. evaluation videos (`utils/render.py`: numpy frames, its own GIF89a;
   host work, no kernel): phase 10's `harness.evaluate` again, its argv
   plus `video=` of arena VIDEO_ARENA (4,096 arenas x 800 steps): the stats
   equal phase 10's bit for bit, the pair-forward and TP-forward launches
   equal phase 10's (800 and 801), and the GIF decodes (`gif_decode`: the
   card's machine has no PIL) to 400 frames equal to the renderer's frames
   of the collected arrays (prints the GIF's size); the card's frame dict
   against
   the CPU's (16 arenas x 32 steps; the pursuers within 1e-2, the evader's
   y within two of its steps); `harness.train` at phase 10's cut with
   eval_interval=1 video=1 (2 iterations: eval_1.gif, eval_2.gif); two
   ranks sharing the card over gloo (`--dp-worker video`, 512 arenas each,
   the arena on rank 1, learning rate 0): rank 0 writes the GIF, rank 1
   none, its frames equal the one-rank run's; `python -m
   mupe_tpu_torch.examples.demo_hideandseek_rollout --gif` in a child
   process (exit 0, 100 frames).

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
over phase 5's, the loss kernels over phase 6's run of their mode; the pair
forward's and the TP forward's `eval_launches` over one of phase 10's
evaluations; the forward's and the backward's
`share_actor_false_launches_per_iteration` over phase 12's run and their
`option_specs` times); the last
line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import math
import mmap
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

# outside a checkout of the repo this fails here, before any output
from mupe_tpu_torch.ops.tolerance import in_f64
from mupe_tpu_torch.utils import trace

NUM_ENVS = 4096
STEPS = 64
# each kernel wrapper's launches: the program's kernel spans that count
# them (the encoder backward's, of one network or two, summed)
KERNEL_SPANS = {"encoder_forward": ("kernel.encoder_fwd",),
                "encoder_pair_forward": ("kernel.pair_fwd",),
                "encoder_backward": ("kernel.encoder_bwd", "kernel.pair_bwd"),
                "weight_grads": ("kernel.weight_grad",),
                "pair_forward_loss": ("kernel.pair_fwd_loss",),
                "pair_forward_loss_agrad": ("kernel.pair_fwd_loss_agrad",),
                "tp_forward": ("kernel.tp_fwd",), "tp_backward": ("kernel.tp_bwd",),
                "tp_weight_grads": ("kernel.tp_weight_grad",),
                "farthest_point_sampling": ("kernel.fps",)}
TIMING_RUNS = 20
# rollouts or training iterations a run of phases 3-6: the first captures
# the CUDA graphs, the second only replays them
ITERS = 2
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
EVAL_EPISODE = 800                 # HideAndSeekCfg.max_episode_length, the paper's episode
# README's composed recipe (AEG + easy-case bootstrap + eval exposure + adaptive entropy)
RECIPE = ("env.use_init_easy_cases=true", "env.max_cylinders=6", "env.eval_spawn_ratio=0.3",
          "env.eval_scenario_ratio=0.25", "env.starve_cycles=8", "env.starve_ratio_unif=0.7",
          "algo.entropy_target=1.2")
RECIPE_ITERS = 5
JITTER_EPISODE = 200               # the jittered evaluation's episodes, cut from 800
# phase 11: the drive recipe's Hover configuration and its card-vs-CPU checks
HOVER_ENVS, HOVER_EPISODE, HOVER_STEPS, HOVER_MINIBATCHES = 1024, 300, 32, 8
HOVER_SECONDS = 90.0               # phase 11's training, about
# and at least this many iterations, whatever the host's speed: the seeded
# drive's first-10 vs last-10 pos_error check fails up to 46 iterations (the
# episodes' rising distance outweighs what was learned) and holds from 47
HOVER_MIN_ITERS = 90
HOVER_SIM2REAL = dict(obs_noise=True, latency=True, payload=True, obs_omega=True, obs_motor=True,
                      action_noise=True)
HOVER_DR = dict(dr_mass_scale=(0.8, 1.2), dr_inertia_scale=(0.7, 1.3), dr_t2w_scale=(0.8, 1.2),
                dr_f2m_scale=(0.8, 1.2), dr_drag_scale=(0.5, 1.5),
                dr_rotor_offset_scale=(-0.1, 0.1), dr_tau_up=(0.01, 0.05),
                dr_tau_down=(0.01, 0.05), payload=True)
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
    hold_rollout(tree_to(traj_g, "cpu"), traj_c)


def hold_rollout(traj_g, traj_c) -> None:
    """The card's trajectory against the CPU's: values and actions within
    3e-2 of their scale, rewards, TP inputs and observations within 1e-2,
    the same dones."""
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


def phase_slice(dev) -> None:
    from mupe_tpu_torch.envs.hideandseek import STAT_KEYS
    from mupe_tpu_torch.learning import init_carry, make_rollout

    log(f"[3] slice: HideAndSeek {NUM_ENVS} arenas x {STEPS} steps, MAPPO act + TP net")
    env, policy = make_slice(dev, NUM_ENVS, 800)
    carry = init_carry(env, policy, torch.Generator(device=dev).manual_seed(0))
    rollout = make_rollout(env, policy)
    wrappers = Launches("encoder_pair_forward", "encoder_forward", "tp_forward")
    for _ in range(ITERS):
        carry, traj, ep_stats = rollout(carry)
    value = policy.value_op(carry.ts, carry.obs)
    torch.cuda.synchronize()
    launches = wrappers.read()
    log(f"  launches over {ITERS} rollouts + value_op: {launches}")
    if (launches["encoder_pair_forward"] < STEPS * ITERS
            or launches["tp_forward"] < STEPS * ITERS
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
    loss_kernels = {"fwdloss": "pair_forward_loss", "agrad": "pair_forward_loss_agrad"}
    counter = Launches(*loss_kernels.values())
    for d, pol in pols.items():
        state, metrics = pol.train_op(ts[d], tree_to(traj, d), tree_to(carry.obs, d), perms=perms)
        out[d] = (state, {k: float(v) for k, v in metrics.items()})
    took = {m: counter.read()[name] for m, name in loss_kernels.items()}
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


def run_train_iters(train_iter, carry, iters: int = ITERS):
    """`iters` iterations: (carry, the last one's metrics and ep_stats)."""
    for _ in range(iters):
        carry, metrics, ep_stats = train_iter(carry)
    return carry, metrics, ep_stats


def check_train_outputs(carry, metrics, ep_stats) -> None:
    """The metrics' keys, and every metric, stat and parameter finite."""
    if set(metrics) != METRIC_KEYS:
        raise AssertionError(f"metrics keys {sorted(metrics)}")
    if not (_all_finite(metrics) and _all_finite(ep_stats)
            and all(bool(torch.isfinite(p).all()) for p in
                    (carry.ts.actor.flat, carry.ts.log_std, carry.ts.critic.flat))):
        raise AssertionError("non-finite metric or parameter after training")
    log("  metrics: " + ", ".join(f"{k}={float(v):.5g}" for k, v in sorted(metrics.items())))


def phase_train(dev) -> dict:
    from mupe_tpu_torch.learning import init_carry, make_train_iter

    log(f"[4] training: make_train_iter, HideAndSeek {NUM_ENVS} arenas x {STEPS} steps, "
        f"bench.py's MAPPOCfg (16 minibatches, 4 PPO epochs, TP net)")
    env, policy = make_slice(dev, NUM_ENVS, 800)
    carry = init_carry(env, policy, torch.Generator(device=dev).manual_seed(2))
    train_iter = make_train_iter(env, policy)
    wrappers = Launches("encoder_pair_forward", "encoder_forward", "tp_forward",
                        "encoder_backward", "weight_grads", "tp_backward", "tp_weight_grads")
    carry, metrics, ep_stats = run_train_iters(train_iter, carry)
    launches = wrappers.read()
    iters = ITERS
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
    check_graphed_iteration(env, policy, carry)
    check_update_against_cpu(dev)
    return launches


def _eager_site(fn, *args, generators=(), **_):
    """A graphed call site's eager twin: its function, run as it is."""
    with trace.span("graph.eager"):
        return fn(*generators, *args)


def _bits_equal(a, b) -> bool:
    from mupe_tpu_torch.utils import graphs

    (la, sa), (lb, sb) = graphs.flatten(a), graphs.flatten(b)
    flat = [(x.detach().contiguous().reshape(-1).view(torch.uint8),
             y.detach().contiguous().reshape(-1).view(torch.uint8)) for x, y in zip(la, lb)]
    return sa == sb and len(la) == len(lb) and all(torch.equal(x, y) for x, y in flat)


def check_graphed_iteration(env, policy, carry) -> None:
    """One training iteration whose rollout replays its CUDA graphs (act and
    the env step's two segments) against one whose sites run their eager
    segments, from twins of the carry: the trajectory, the episode stats,
    the metrics, the parameters and optimizer state after the update, the
    env state and the generator are the same bits.  Prints the graphed
    iteration's replay share (`graph.replay` over `graph.replay` +
    `graph.eager` calls)."""
    import copy

    from mupe_tpu_torch.learning import make_rollout

    def twin():
        gen = torch.Generator(device=carry.generator.device)
        gen.set_state(carry.generator.get_state())
        return dataclasses.replace(copy.deepcopy(dataclasses.replace(carry, generator=None)),
                                   generator=gen)

    def iteration(c):
        c, traj, ep_stats = make_rollout(env, policy)(c)
        ts, metrics = policy.train_op(c.ts, traj, c.obs, c.generator, last_state=c.state,
                                      shard=env.shard)
        return (traj, ep_stats, metrics, ts.actor_params(), ts.critic_params(),
                list(ts.tp_net.leaves()), ts.actor_opt, ts.critic_opt, c.env_state,
                c.obs), c.generator.get_state()

    before = trace.counts().copy()
    graphed, gen_g = iteration(twin())
    calls = trace.counts() - before
    sites = (env, "_graph_a"), (env, "_graph_b"), (policy, "_act_graph")
    saved = [getattr(obj, name) for obj, name in sites]
    try:
        for obj, name in sites:
            setattr(obj, name, _eager_site)
        eager, gen_e = iteration(twin())
    finally:
        for (obj, name), site in zip(sites, saved):
            setattr(obj, name, site)
    share = calls["graph.replay"] / max(calls["graph.replay"] + calls["graph.eager"], 1)
    same = _bits_equal(graphed, eager) and torch.equal(gen_g, gen_e)
    log(f"  graphed iteration vs the eager segments: {calls['graph.replay']} replays, "
        f"{calls['graph.eager']} eager calls, {calls['graph.capture']} captures (replay share "
        f"{share:.4f}); every output, parameter and the generator bit-identical: {same}")
    if not same:
        raise AssertionError("the graphed iteration differs from the eager segments")


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
    cpu, added_c = update_history(gb, 0.0, 0.9)
    card, added_g = update_history(tree_to(gb, dev), 0.0, 0.9)
    card = tree_to(card, "cpu")
    log(f"  update_history card vs CPU: {int(added_g)} vs {int(added_c)} added, history_len "
        f"{int(card.history_len)} vs {int(cpu.history_len)}, history bit-identical: "
        f"{torch.equal(card.history, cpu.history)}")
    if not (int(added_g) == int(added_c) and int(card.history_len) == int(cpu.history_len)
            and torch.equal(card.history, cpu.history)):
        raise AssertionError("update_history on the card disagrees with the CPU")


def phase_aeg(dev) -> dict:
    """AEG training through the port's entry point: `harness.train` with task
    HideAndSeek_envgen at 4096 arenas, a 5000-task buffer and the TP net,
    bench.py's MAPPOCfg.  Cut so that cycles close inside the run:
    max_episode_length 16 (a 3-episode cycle closes inside one 64-step
    iteration) and the buffer full from the easy cases with r_min = 0 (every
    cycle overflows it and downsamples by FPS)."""
    from mupe_tpu_torch import harness
    from mupe_tpu_torch.envs.hideandseek_envgen import envgen_extra_stats
    from mupe_tpu_torch.learning import init_carry
    from mupe_tpu_torch.utils.checkpoint import load_checkpoint, to_plain
    from mupe_tpu_torch.utils.config import parse_cli

    iters = ITERS
    log(f"[5] AEG training: harness.train task=HideAndSeek_envgen, {NUM_ENVS} arenas x {STEPS} "
        f"steps, buffer {AEG_BUFFER}, TP net; cuts: max_episode_length={AEG_EPISODE}, "
        f"use_init_easy_cases with r_min=0")
    wrappers = Launches("encoder_pair_forward", "encoder_forward", "tp_forward",
                        "encoder_backward", "weight_grads", "tp_backward",
                        "farthest_point_sampling")
    with tempfile.TemporaryDirectory() as run_dir:
        argv = [f"env.num_envs={NUM_ENVS}", f"env.max_episode_length={AEG_EPISODE}",
                f"env.buffer_length={AEG_BUFFER}", "env.use_init_easy_cases=true",
                "env.r_min=0.0", f"algo.train_every={STEPS}", f"max_iters={iters}",
                "log_interval=1", "save_interval=-1", f"run_dir={run_dir}", "run_name=aeg",
                "seed=3"]
        wrappers.reset()
        metrics = harness.train(argv, default_task="HideAndSeek_envgen", device=dev)
        launches = wrappers.read()
        log(f"  launches over {iters} iterations: {launches}")
        cycles = (iters * STEPS // AEG_EPISODE) // 3
        if launches["farthest_point_sampling"] < 1 or any(v < 1 for v in launches.values()):
            raise AssertionError(f"the AEG path skipped a kernel: {launches}")
        log(f"  FPS launches {launches['farthest_point_sampling']} for {cycles} closed cycles")
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
    check_update_history_against_cpu(dev, saved["env_state"]["gen"])
    return launches


def phase_inkernel(dev) -> dict:
    """Training with the in-kernel loss (`use_inkernel_loss=True`) at phase
    4's configuration, in each `direct_mode`.  Returns each loss kernel's
    launches over the run of its mode."""
    from mupe_tpu_torch.learning import init_carry, make_train_iter

    iters = ITERS
    wrappers = Launches("pair_forward_loss", "pair_forward_loss_agrad", "encoder_backward",
                        "weight_grads", "encoder_pair_forward", "encoder_forward", "tp_forward",
                        "tp_backward")
    kernel = {"fwdloss": "pair_forward_loss", "agrad": "pair_forward_loss_agrad"}
    minibatches = 16 * 4
    out = {}
    for mode in ("fwdloss", "agrad"):
        log(f"[6] in-kernel-loss training, direct_mode={mode!r}: make_train_iter, phase 4's "
            f"configuration with use_inkernel_loss=True")
        env, policy = make_slice(dev, NUM_ENVS, 800, use_inkernel_loss=True, direct_mode=mode)
        carry = init_carry(env, policy, torch.Generator(device=dev).manual_seed(4))
        train_iter = make_train_iter(env, policy)
        wrappers.reset()
        carry, metrics, ep_stats = run_train_iters(train_iter, carry)
        launches = wrappers.read()
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
        check_update_against_cpu(dev, use_inkernel_loss=True, direct_mode=mode)
        out[kernel[mode]] = launches[kernel[mode]]
        if mode == "agrad":  # its stage B (and the critic backward's)
            out[f"{kernel[mode]}:stage_b"] = launches["weight_grads"]
    return out


def phase_config_train(dev, phase: int, label: str, env_kw: dict, modes) -> None:
    """Training at another HideAndSeek configuration through `harness.build`
    (as `python -m mupe_tpu_torch.train env.<field>=<value> ...` builds it),
    at WIDE_NUM_ENVS arenas: 2 iterations in each of `modes` (None: the
    default update; "fwdloss", "agrad": the in-kernel loss); the launch
    counts, finite outputs and the update on the card against the CPU for
    each."""
    from mupe_tpu_torch import harness
    from mupe_tpu_torch.learning import init_carry, make_train_iter

    wrappers = Launches("encoder_pair_forward", "encoder_forward", "tp_forward",
                        "encoder_backward", "weight_grads", "tp_backward", "tp_weight_grads",
                        "pair_forward_loss", "pair_forward_loss_agrad")
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
        wrappers.reset()
        carry, metrics, ep_stats = run_train_iters(train_iter, carry, 2)
        launches = wrappers.read()
        log(f"  launches over 2 iterations: {launches}")
        if (launches["encoder_backward"] < 2 * 64 or launches["tp_backward"] < 2
                or launches["tp_weight_grads"] != launches["tp_backward"]
                or launches[update[mode]] < 2 * 64 or launches["tp_forward"] < 2 * (STEPS + 1)):
            raise AssertionError(f"the {label} configuration skipped a kernel: {launches}")
        check_train_outputs(carry, metrics, ep_stats)
        check_update_against_cpu(dev, env_kw=env_kw, **algo)


def phase_recipe(dev, run_dir: str) -> Path:
    """README's composed recipe through `harness.train` with
    `train_generator`'s defaults (task HideAndSeek_envgen) at NUM_ENVS
    arenas, cut as phase 5 (16-step episodes and r_min = 0, so that cycles
    close and downsample by FPS), with an evaluation episode every
    iteration, the NaN guard and a profiler trace of iterations 1-3.
    Checks the eval rows, the trace, the FPS launches and the mixing
    fractions of the recipe's scene sampler; returns the checkpoint
    directory."""
    from mupe_tpu_torch import harness
    from mupe_tpu_torch.utils.config import parse_cli

    prof = Path(run_dir) / "prof"
    argv = [f"env.num_envs={NUM_ENVS}", *RECIPE, f"env.max_episode_length={AEG_EPISODE}",
            "env.r_min=0.0", f"max_iters={RECIPE_ITERS}", "eval_interval=1", "guard_nan=true",
            f"profile_dir={prof}", "log_interval=1", "save_interval=-1", f"run_dir={run_dir}",
            "run_name=recipe", "seed=10"]
    log(f"[10] composed recipe: harness.train task=HideAndSeek_envgen {' '.join(RECIPE)}, "
        f"{NUM_ENVS} arenas; cuts: env.max_episode_length={AEG_EPISODE} env.r_min=0.0 "
        f"max_iters={RECIPE_ITERS}; eval_interval=1 guard_nan=true profile_dir")
    wrappers = Launches("encoder_pair_forward", "farthest_point_sampling")
    metrics = harness.train(argv, default_task="HideAndSeek_envgen", device=dev)
    launches = wrappers.read()
    log(f"  launches over {RECIPE_ITERS} iterations and their evaluation episodes: {launches}")
    if (launches["farthest_point_sampling"] < 1
            or launches["encoder_pair_forward"] < RECIPE_ITERS * (2 * STEPS + AEG_EPISODE)):
        raise AssertionError(f"the recipe skipped a kernel: {launches}")
    with open(Path(run_dir) / "recipe" / "metrics.csv") as f:
        all_rows = list(csv.DictReader(f))
    rows = [r for r in all_rows if r.get("eval/episode_count")]
    evals = [float(v) for r in rows for k, v in r.items() if k.startswith("eval/")]
    if len(rows) != RECIPE_ITERS or not all(math.isfinite(v) for v in evals):
        raise AssertionError(f"{len(rows)} eval rows, or a non-finite eval stat")
    if "stats/nan_skipped" in metrics or not math.isfinite(metrics["policy_loss"]):
        raise AssertionError("the guarded recipe skipped an iteration")
    trace = prof / "trace.json"
    with open(trace, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
        named = m.find(b"encoder_fwd_kernel") >= 0
    if not named:
        raise AssertionError(f"{trace} does not name the pair forward's kernel")
    log(f"  eval rows {len(rows)}: eval/success {metrics['eval/success']:.4f}, eval/return "
        f"{metrics['eval/return']:.4f}, eval/episode_count {metrics['eval/episode_count']:.0f}; "
        f"trace {trace.name} ({trace.stat().st_size} bytes) names encoder_fwd_kernel")

    sections, _ = parse_cli(argv)
    env, _, _, _ = harness.build("HideAndSeek_envgen", dict(sections["env"], eval_mix_rotate=False),
                                 None, device=dev)
    d, _, _, cyl, _, _ = env._sample_scene(torch.Generator(device=dev).manual_seed(11))
    on_spawn = ((d[:, None] - env._mix_spawn_d[None]).abs().amax(dim=(2, 3)) < 1e-5).any(1)
    on_full = ((cyl[:, None] - env._mix_full_cyl[None]).abs().amax(dim=(2, 3)) < 1e-5).any(1)
    spawn_frac, full_frac = float(on_spawn.float().mean()), float(on_full.float().mean())
    log(f"  mixing at {NUM_ENVS} arenas, eval_mix_rotate=False: {spawn_frac:.4f} on a spawn "
        f"table (want 1 - 0.7 x 0.75 = 0.475 +- 0.05), {full_frac:.4f} on a full scenario's "
        f"cylinders (want 0.25 +- 0.05; full scenarios {env._mix_full_scenarios})")
    if not (abs(spawn_frac - 0.475) <= 0.05 and abs(full_frac - 0.25) <= 0.05):
        raise AssertionError("the recipe's mixing fractions are out of range")
    return Path(run_dir) / "recipe" / "checkpoints"


def phase_evaluate(dev, model_dir: Path) -> dict:
    """`harness.evaluate` (`python -m mupe_tpu_torch.eval`) at NUM_ENVS arenas
    on the wall scenario in eval mode, 800-step greedy episodes, from the
    recipe's checkpoint: every episode ends (by truncation), every stat is
    finite, one pair-forward launch a step and one TP forward a step plus
    the first observation's.  Then eval mode over random cylinders with
    jitter (episodes cut to JITTER_EPISODE steps): every trial a distinct
    scene.  Returns the first evaluation's launch counts, result and argv."""
    from mupe_tpu_torch import harness
    from mupe_tpu_torch.utils.config import parse_cli

    argv = [f"env.num_envs={NUM_ENVS}", "env.use_random_cylinder=false", "env.scenario_flag=wall",
            "env.use_eval=true", f"model_dir={model_dir}", "seed=0"]
    log(f"[10] evaluation: harness.evaluate {' '.join(argv[:4])}, {EVAL_EPISODE}-step greedy "
        f"episodes, the recipe's checkpoint")
    wrappers = Launches("encoder_pair_forward", "tp_forward")
    result = harness.evaluate(argv, device=dev)
    launches = wrappers.read()
    log(f"  launches over one evaluation: {launches}")
    if launches != {"encoder_pair_forward": EVAL_EPISODE, "tp_forward": EVAL_EPISODE + 1}:
        raise AssertionError(f"launches {launches}: want one pair forward a step and one TP "
                             f"forward a step plus the first observation's")
    pcts = [f"first_capture_step_p{q}" for q in (25, 50, 75)]
    if (result["episodes"] != NUM_ENVS or not all(k in result for k in pcts)
            or not all(math.isfinite(v) for v in result.values())):
        raise AssertionError(f"evaluation: episodes {result['episodes']}, or a stat missing or "
                             f"non-finite")
    first = dict(launches=launches, result=result, argv=argv)

    argv = [f"env.num_envs={NUM_ENVS}", "env.use_eval=true", "env.eval_jitter_xy=0.05",
            "env.eval_jitter_rpy=0.1", f"env.max_episode_length={JITTER_EPISODE}",
            f"model_dir={model_dir}", "seed=0"]
    log(f"  jittered evaluation over random cylinders: {' '.join(argv[1:5])}")
    result = harness.evaluate(argv, device=dev)
    if result["episodes"] != NUM_ENVS or not all(math.isfinite(v) for v in result.values()):
        raise AssertionError("jittered evaluation: an episode unfinished or a stat non-finite")
    sections, _ = parse_cli(argv)
    env, _, _, _ = harness.build("HideAndSeek", sections["env"], None, device=dev)
    state = env.reset(torch.Generator(device=dev).manual_seed(0))
    scenes = torch.cat([t.reshape(NUM_ENVS, -1) for t in (
        state.drone.pos, state.drone.quat, state.target_pos, state.cylinders)], dim=1)
    distinct = torch.unique(scenes, dim=0).shape[0]
    log(f"  {distinct} distinct scenes of {NUM_ENVS} trials")
    if distinct != NUM_ENVS:
        raise AssertionError("jittered eval trials repeat a scene")
    return first


def check_eval_against_cpu(dev) -> None:
    """The card's evaluation (kernels) against the CPU's (plain versions):
    the wall scenario in eval mode without jitter draws nothing, so both
    start from the same scene; 16 arenas, a 32-step greedy episode, the
    same weights with the heads at unit gain.  Teacher-forced: each step
    the card acts on the CPU's observation and steps the CPU's state with
    the CPU's action, so each of its outputs (action and value from the
    pair kernel, reward, observation and TP input from the env step with
    the TP kernel) is compared from identical inputs, to phase 3's limits
    (`hold_rollout`), and the episode stats at the done step within 1e-2.
    The drones reach the 1 m/s speed clamp within 32 steps, where the
    speed penalty (-10 when speed > v_drone) falls on the last bit of the
    clamped speed; a penalty may differ only there, and rewards and stats
    are held without it.  `evaluate` free-running on both is run and its
    largest stat difference printed."""
    from mupe_tpu_torch import harness
    from mupe_tpu_torch.envs import tree_to
    from mupe_tpu_torch.learning import init_carry
    from mupe_tpu_torch.utils.checkpoint import save_checkpoint
    from mupe_tpu_torch.utils.config import parse_cli

    steps = 32
    log(f"[10] evaluation, card vs CPU: wall, use_eval, 16 arenas, a {steps}-step greedy "
        f"episode, teacher-forced")
    argv = ["env.num_envs=16", f"env.max_episode_length={steps}",
            "env.use_random_cylinder=false", "env.scenario_flag=wall"]
    env_kw = dict(parse_cli(argv)[0]["env"], use_eval=True)
    (env_c, pol_c, _, _), (env_g, pol_g, _, _) = (
        harness.build("HideAndSeek", env_kw, None, device=d) for d in ("cpu", dev))
    template = {k: torch.zeros((1,) + s) for k, s in env_c.obs_groups().items()}
    ts_c = pol_c.init(template, torch.Generator().manual_seed(8))
    ts_g = pol_g.init(template, torch.Generator().manual_seed(8))  # the same weights
    with torch.no_grad():  # heads at unit gain: O(1) actions that drive the drones
        for t in (ts_c, ts_g):
            t.actor.leaves[-2].mul_(100.0)
            t.critic.leaves[-2].mul_(100.0)
    carry = init_carry(env_c, pol_c, torch.Generator().manual_seed(9), ts_c)
    gen_c, gen_g = torch.Generator().manual_seed(10), torch.Generator(device=dev).manual_seed(10)
    state, obs = carry.env_state, carry.obs
    cols = {d: {k: [] for k in ("value", "action", "reward", "done", "tp_input", "obs", "speed")}
            for d in ("cpu", dev)}
    for _ in range(steps):
        a_c, _, v_c = pol_c.act(ts_c, obs, deterministic=True)
        a_g, _, v_g = pol_g.act(ts_g, tree_to(obs, dev), deterministic=True)
        next_state, tr_c = env_c.step(state, a_c, gen_c, ts_c.tp_net)
        _, tr_g = env_g.step(tree_to(state, dev), a_c.to(dev), gen_g, ts_g.tp_net)
        for d, a, v, tr in (("cpu", a_c, v_c, tr_c), (dev, a_g, v_g, tree_to(tr_g, "cpu"))):
            speed = torch.linalg.vector_norm(tr.info["drone_state"][..., 7:10], dim=-1)
            for k, x in (("value", v.cpu()), ("action", a.cpu()), ("reward", tr.reward),
                         ("done", tr.done), ("tp_input", tr.info["tp_input"]), ("obs", tr.obs),
                         ("speed", speed)):
                cols[d][k].append(x)
        state, obs = next_state, tr_c.obs
    trajs = {d: {k: (torch.stack(v) if k != "obs" else
                     {n: torch.stack([o[n] for o in v]) for n in v[0]})
                 for k, v in c.items()} for d, c in cols.items()}
    # the speed penalty -speed_coef * (speed > v_drone) is decided by the
    # last bit where the dynamics clamp the speed to v_drone: it may differ
    # there, and only there; the rewards are held without it
    cfg = env_c.cfg
    speed = {d: trajs[d].pop("speed") for d in trajs}                     # [T, E, n]
    pen = {d: -cfg.speed_coef * (speed[d] > cfg.v_drone).float() for d in speed}
    flip = pen[dev] != pen["cpu"]
    at_clamp = ((speed["cpu"] - cfg.v_drone).abs() < 1e-6) & ((speed[dev] - cfg.v_drone).abs() < 1e-6)
    log(f"  speed penalties that differ: {int(flip.sum())} of {flip.numel()}, all at the "
        f"{cfg.v_drone} m/s clamp (|speed - v_drone| < 1e-6 on both): {bool(at_clamp[flip].all())}; "
        f"{int(at_clamp.sum())} at the clamp")
    if not bool(at_clamp[flip].all()):
        raise AssertionError("a speed penalty differs away from the speed clamp")
    for d in trajs:
        trajs[d]["reward"] = trajs[d]["reward"] - pen[d][..., None]
    hold_rollout(trajs[dev], trajs["cpu"])
    done = tr_c.done.float()
    if not bool(done.all()):
        raise AssertionError("the episode did not end at its last step")
    stats_g = dict(tree_to(tr_g.stats, "cpu"))
    last = (pen[dev][-1] - pen["cpu"][-1]).mean(-1, keepdim=True)         # [E, 1]
    stats_g["speed_reward"] = stats_g["speed_reward"] - last / steps   # normalised at done
    stats_g["return"] = stats_g["return"] - last
    errs = {k: abs(float(torch.mean(stats_g[k] * done)) - float(torch.mean(v * done)))
            for k, v in tr_c.stats.items()}
    worst = max(errs, key=errs.get)
    log(f"  card vs CPU episode stats: largest error {errs[worst]:.3e} ({worst}; tol 1e-2)")
    if not errs[worst] <= 1e-2:
        raise AssertionError("card and CPU evaluations disagree on the episode stats")
    with tempfile.TemporaryDirectory() as ckpt:
        save_checkpoint(ckpt, 0, ts_c)
        res = {d: harness.evaluate(argv + [f"model_dir={ckpt}"], device=d) for d in ("cpu", dev)}
    free = {k: abs(res[dev][k] - v) for k, v in res["cpu"].items()}
    worst = max(free, key=free.get)
    log(f"  free-running evaluate, card vs CPU: largest stat difference {free[worst]:.3e} "
        f"({worst}); episodes {res[dev]['episodes']:.0f} / {res['cpu']['episodes']:.0f}")
    if set(res[dev]) != set(res["cpu"]) or res[dev]["episodes"] != res["cpu"]["episodes"]:
        raise AssertionError("card and CPU evaluations report different results")


def check_guard(dev) -> None:
    """`guard_train_iter` on the card: an iteration at bench.py's
    configuration whose loss is forced non-finite must leave the carry as
    it was, bit for bit (parameters and Adam states written in place, the
    env state, the observation, the CUDA generator's state), and flag
    `nan_skipped`."""
    from mupe_tpu_torch.learning import init_carry, make_train_iter
    from mupe_tpu_torch.utils.checkpoint import to_plain
    from mupe_tpu_torch.utils.debug import guard_train_iter

    log(f"[10] NaN guard: one iteration at {NUM_ENVS} arenas with its policy_loss forced to NaN")
    env, policy = make_slice(dev, NUM_ENVS, 800)
    carry = init_carry(env, policy, torch.Generator(device=dev).manual_seed(12))
    real = make_train_iter(env, policy)

    def poisoned(c, *args, **kwargs):
        c, metrics, stats = real(c, *args, **kwargs)
        return c, {**metrics, "policy_loss": torch.full((), math.nan, device=dev)}, stats

    before = to_plain(carry)
    out, _, stats = guard_train_iter(poisoned)(carry)
    restored = _equal_trees(to_plain(carry), before)
    log(f"  nan_skipped {float(stats['nan_skipped']):.0f}; carry (generator state included) "
        f"bit-identical after the restore: {restored}")
    if not (out is carry and restored and float(stats["nan_skipped"]) == 1.0):
        raise AssertionError("the guard did not restore the carry")


def phase_eval(dev, run_dir: str) -> dict:
    """Phase 10: the composed recipe (its run in `run_dir`), evaluation at
    full width, the card's evaluation against the CPU's, and the NaN guard.
    Returns the evaluation's launch counts, result and argv."""
    model_dir = phase_recipe(dev, run_dir)
    first = phase_evaluate(dev, model_dir)
    check_eval_against_cpu(dev)
    check_guard(dev)
    return first


def _flat_part(obs):
    """The flat policy observation of a Hover observation (its "observation"
    branch under domain randomization)."""
    return obs["observation"] if isinstance(obs, dict) else obs


def _flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def check_hover_against_cpu(dev, label: str, env_kw: dict) -> None:
    """The card's Hover step and flat policy against the CPU's,
    teacher-forced: 16 arenas x 32 steps (episodes of 12, so two
    auto-resets), from one set of weights (heads at unit gain).  Each step
    the card copies the CPU's state, acts on the CPU's observation (actor
    mean, critic value: bf16 trunks, within 3e-2 of their scale, phase 3's
    limit) and steps with the CPU's action and the CPU's draws (noise,
    resets): observations, reward and every stat within 1e-4 of their scale
    (max(1, largest magnitude); the port's CPU free run against JAX's is
    held so).  A pos_bonus or head_bonus that differs is a flip at the 0.02
    threshold: counted and printed, each must sit within 1e-4 of it, and
    the flipped arenas' reward, return and bonuses are left out."""
    from mupe_tpu_torch.core import quat_axis
    from mupe_tpu_torch.envs import Hover, HoverCfg, tree_to
    from mupe_tpu_torch.learning import MAPPOCfg, MAPPOPolicy

    cfg = dict(num_envs=16, max_episode_length=12, **env_kw)
    env_c, env_g = Hover(HoverCfg(**cfg), device="cpu"), Hover(HoverCfg(**cfg), device=dev)
    pols = {d: MAPPOPolicy(MAPPOCfg(), 1, 4, obs_is_dict=False, device=d) for d in ("cpu", dev)}
    state = env_c.reset(torch.Generator().manual_seed(21))
    obs = _flat_part(env_c.observe(state))
    ts_c = pols["cpu"].init(obs, torch.Generator().manual_seed(22))
    with torch.no_grad():  # heads at unit gain: O(1) actions that move the drone
        ts_c.actor.leaves[-2].mul_(100.0)
        ts_c.critic.leaves[-2].mul_(100.0)
    ts_g = pols[dev].init(obs.to(dev), actor_leaves=ts_c.actor.leaves, log_std=ts_c.log_std,
                          critic_leaves=ts_c.critic.leaves)
    draws, real_u, real_n = [], env_c._uniform, env_c._normal

    def record(fn):
        def draw(*args):
            v = fn(*args)
            draws.append(v)
            return v
        return draw

    env_c._uniform, env_c._normal = record(real_u), record(real_n)
    env_g._uniform = lambda gen, shape, lo, hi: draws.pop(0).to(dev)
    env_g._normal = lambda gen, shape: draws.pop(0).to(dev)
    gen_c, gen_g = torch.Generator().manual_seed(23), torch.Generator(device=dev)
    errs, scales, flips, at_threshold, resets = {}, {}, 0, True, 0

    def hold(name, got, want, keep=None):
        got = got.detach().cpu().float()
        want = want.detach().float()
        if keep is not None:
            got, want = got[keep], want[keep]
        if want.numel():
            errs[name] = max(errs.get(name, 0.0), float((got - want).abs().max()))
            scales[name] = max(scales.get(name, 0.0), float(want.abs().max()))

    target = env_c._target_pos
    for _ in range(32):
        a_c, _, v_c = pols["cpu"].act(ts_c, obs, deterministic=True)
        a_g, _, v_g = pols[dev].act(ts_g, obs.to(dev), deterministic=True)
        hold("actor mean", a_g, a_c)
        hold("critic value", v_g, v_c)
        state_g = tree_to(state, dev)
        state, tr_c = env_c.step(state, a_c, gen_c)
        _, tr_g = env_g.step(state_g, a_c.to(dev), gen_g)
        if draws:
            raise AssertionError("the card's step took fewer draws than the CPU's")
        resets += int(bool(tr_c.done.all()))
        flip = ((tr_g.stats["pos_bonus"].cpu() != tr_c.stats["pos_bonus"])
                | (tr_g.stats["head_bonus"].cpu() != tr_c.stats["head_bonus"]))[:, 0]
        if bool(flip.any()):
            d = tr_c.info["drone_state"][:, 0]
            pos_err = torch.linalg.vector_norm(target - d[:, :3], dim=-1)
            head_err = torch.linalg.vector_norm(
                env_c._target_heading - quat_axis(d[:, 3:7], 0), dim=-1)
            near = ((pos_err - 0.02).abs() < 1e-4) | ((head_err - 0.02).abs() < 1e-4)
            at_threshold = at_threshold and bool(near[flip].all())
            flips += int(flip.sum())
        keep = ~flip
        obs_g = _flat_leaves({"obs": tr_g.obs})
        for k, v in _flat_leaves({"obs": tr_c.obs}).items():
            hold(k, obs_g[k], v)
        for k, v in tr_c.stats.items():
            gated = k in ("return", "pos_bonus", "head_bonus")
            hold(f"stats/{k}", tr_g.stats[k], v, keep if gated else None)
        hold("reward", tr_g.reward, tr_c.reward, keep)
        obs = _flat_part(tr_c.obs)
    log(f"  {label}: card vs CPU, teacher-forced, 16 arenas x 32 steps ({resets} auto-resets); "
        f"bonus flips at the 0.02 thresholds: {flips} of {16 * 32} (all at a threshold: "
        f"{at_threshold})")
    bad = []
    for name in errs:
        rel = 3e-2 if name in ("actor mean", "critic value") else 1e-4
        limit = rel * (scales[name] if rel == 3e-2 else max(1.0, scales[name]))
        if not errs[name] <= limit:
            bad.append(name)
    log("    max_abs_err (scale): " + "; ".join(
        f"{n} {errs[n]:.3e} ({scales[n]:.3e})" for n in errs))
    if bad or not at_threshold or resets != 2:
        raise AssertionError(f"card and CPU Hover disagree on {bad} (flips at the threshold: "
                             f"{at_threshold}, resets {resets})")


def check_hover_update_against_cpu(dev) -> None:
    """One flat `train_op` on the card against the CPU: 16 arenas x 16 steps
    of a CPU rollout (the sim2real options on), the recipe's hidden widths in
    bf16, 1 epoch of 2 minibatches from the same weights and permutation.
    Metrics within 1e-2 relative (+1e-4), parameters within 3e-3 (two Adam
    steps of about lr = 5e-4; phase 4's bounds for the dict path)."""
    from mupe_tpu_torch.envs import Hover, HoverCfg, tree_to
    from mupe_tpu_torch.learning import MAPPOCfg, MAPPOPolicy, init_carry, make_rollout

    env = Hover(HoverCfg(num_envs=16, max_episode_length=12, **HOVER_SIM2REAL), device="cpu")
    cfg = MAPPOCfg(train_every=16, num_minibatches=2, ppo_epochs=1)
    pols = {d: MAPPOPolicy(cfg, 1, 4, obs_is_dict=False, device=d) for d in ("cpu", dev)}
    carry = init_carry(env, pols["cpu"], torch.Generator().manual_seed(31))
    with torch.no_grad():
        carry.ts.actor.leaves[-2].mul_(100.0)
        carry.ts.critic.leaves[-2].mul_(100.0)
    ts_g = pols[dev].init(carry.obs.to(dev), actor_leaves=carry.ts.actor.leaves,
                          log_std=carry.ts.log_std, critic_leaves=carry.ts.critic.leaves)
    carry, traj, _ = make_rollout(env, pols["cpu"])(carry)
    ts_c = pols["cpu"].init(carry.obs, actor_leaves=carry.ts.actor.leaves,
                            log_std=carry.ts.log_std, critic_leaves=carry.ts.critic.leaves)
    perms = torch.randperm(16 * 16, generator=torch.Generator().manual_seed(32))[None]
    out = {}
    for d, ts in (("cpu", ts_c), (dev, ts_g)):
        new, metrics = pols[d].train_op(ts, tree_to(traj, d), carry.obs.to(d), perms=perms)
        out[d] = (new, {k: float(v) for k, v in metrics.items()})
    (new_c, m_c), (new_g, m_g) = out["cpu"], out[dev]
    worst = max((abs(m_g[k] - m_c[k]) / max(abs(m_c[k]), 1e-5), k) for k in m_c)
    log(f"  flat update, card vs CPU: worst metric relative difference {worst[0]:.3e} ({worst[1]})")
    for k, v in m_c.items():
        if not abs(m_g[k] - v) <= 1e-2 * abs(v) + 1e-4:
            raise AssertionError(f"card and CPU flat updates disagree on {k}: {m_g[k]} vs {v}")
    errs = {n: float((getattr(new_g, n).flat.detach().cpu() - getattr(new_c, n).flat.detach())
                     .abs().max()) for n in ("actor", "critic")}
    errs["log_std"] = float((new_g.log_std.cpu() - new_c.log_std).abs().max())
    log("  flat update, card vs CPU parameters: " + ", ".join(
        f"{k} max_abs_err={v:.3e}" for k, v in errs.items()) + " (tol 3e-3)")
    if not max(errs.values()) <= 3e-3:
        raise AssertionError("card and CPU flat updates disagree on the parameters")


def phase_hover(dev) -> None:
    """Phase 11: Hover + flat MAPPO."""
    from mupe_tpu_torch.envs import Hover, HoverCfg
    from mupe_tpu_torch.envs.hover import STAT_KEYS
    from mupe_tpu_torch.learning import MAPPOCfg, MAPPOPolicy, init_carry, make_train_iter

    log("[11] Hover + MAPPO's flat observations (no kernel on this path)")
    check_hover_against_cpu(dev, "every sim2real option", HOVER_SIM2REAL)
    check_hover_against_cpu(dev, "domain randomization + payload", HOVER_DR)
    check_hover_update_against_cpu(dev)

    env = Hover(HoverCfg(num_envs=HOVER_ENVS, max_episode_length=HOVER_EPISODE), device=dev)
    policy = MAPPOPolicy(MAPPOCfg(train_every=HOVER_STEPS, num_minibatches=HOVER_MINIBATCHES,
                                  hidden_units=(256, 256, 256), compute_dtype="bfloat16"),
                         1, 4, obs_is_dict=False, device=dev)
    log(f"  the drive recipe: HoverCfg(num_envs={HOVER_ENVS}, max_episode_length={HOVER_EPISODE}), "
        f"MAPPOCfg(train_every={HOVER_STEPS}, num_minibatches={HOVER_MINIBATCHES}), hidden "
        f"(256, 256, 256), bf16, about {HOVER_SECONDS:.0f} s and at least {HOVER_MIN_ITERS} "
        "iterations")
    carry = init_carry(env, policy, torch.Generator(device=dev).manual_seed(42))
    train_iter = make_train_iter(env, policy)
    # each iteration's pos_error: the arenas' mean distance to the target at
    # its end; 10 consecutive iterations (320 steps) sample the 300-step
    # episode's phases about evenly.  The episode-end stat (the recipe's) is
    # kept where episodes ended (one iteration in 9.4).
    pos_errors, ended, iters = [], [], 0
    t0 = time.perf_counter()
    while True:
        carry, metrics, ep_stats = train_iter(carry)
        iters += 1
        st = carry.env_state
        pos_errors.append(float(torch.linalg.vector_norm(st.target_pos - st.drone.pos,
                                                         dim=-1).mean()))  # one host read
        if float(ep_stats["episode_count"]) > 0:
            if set(ep_stats) != set(STAT_KEYS) | {"episode_count"}:
                raise AssertionError(f"Hover ep_stats keys {sorted(ep_stats)}")
            if not (_all_finite(ep_stats) and _all_finite(metrics)):
                raise AssertionError("non-finite Hover metric or stat")
            ended.append(float(ep_stats["pos_error"]))
        if time.perf_counter() - t0 >= HOVER_SECONDS and iters >= HOVER_MIN_ITERS:
            break
    if not (_all_finite(metrics) and all(bool(torch.isfinite(p).all()) for p in
                                         (carry.ts.actor.flat, carry.ts.critic.flat))):
        raise AssertionError("non-finite Hover parameter or metric after training")
    first, last = statistics.mean(pos_errors[:10]), statistics.mean(pos_errors[-10:])
    log(f"  Hover training: {iters} iterations")
    log(f"  pos_error (mean distance to the target at an iteration's end): first 10 "
        f"iterations {first:.4f}, last 10 {last:.4f}; by iteration: "
        + " ".join(f"{v:.3f}" for v in pos_errors))
    log(f"  episode-end pos_error ({len(ended)} iterations ended episodes): "
        + " ".join(f"{v:.4f}" for v in ended))
    log("  metrics: " + ", ".join(f"{k}={float(v):.5g}" for k, v in sorted(metrics.items())))
    if not last < first:
        raise AssertionError(f"Hover's pos_error did not fall ({first} -> {last})")


# phase 12: MAPPO's options and the PPO family
OPT_ROWS = NUM_ENVS * STEPS // 16           # one agent's rows of a 49,152-row minibatch
OPT_ITERS = 2                               # each option's training run
FAMILY_ITERS = 2                            # Hover's PPO family (cut from 3 for phase 13)
SDF_ENVS, SDF_STEPS, SDF_POINTS = 512, 8, 64  # ppo_sdf: 4,096 rows x 64 points


def well_formed_state(state):
    """HideAndSeek's critic state with its per-drone cylinders [E, n, k, 5]
    cut to the first drone's [E, k, 5]: HideAndSeek's widths in groups of
    one rank (the env's own state is refused, as the JAX package fails on
    it)."""
    return {"state_drones": state["state_drones"], "cylinders": state["cylinders"][:, 0]}


class WellFormedStateEnv:
    """HideAndSeek whose critic state is `well_formed_state`'s."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def observe_full(self, state, tp_net):
        obs, st = self.env.observe_full(state, tp_net)
        return obs, well_formed_state(st)

    def step(self, state, action, gen, *args):
        state, tr = self.env.step(state, action, gen, *args)
        tr.info["state"] = well_formed_state(tr.info["state"])
        return state, tr


def state_groups() -> tuple:
    """(state_drones, cylinders) widths of HideAndSeek's default
    configuration (bench.py's, TP net on): its critic state's groups."""
    from mupe_tpu_torch.envs import HideAndSeek, HideAndSeekCfg
    from mupe_tpu_torch.learning.tp_net import TPNet

    env = HideAndSeek(HideAndSeekCfg(num_envs=2), device="cpu")
    tp = TPNet(env.cfg.tp_input_dim, 3 * env.cfg.future_prediction_step,
               generator=torch.Generator().manual_seed(0), device="cpu")
    _, st = env.observe_full(env.reset(torch.Generator().manual_seed(0)), tp)
    st = well_formed_state(st)
    return tuple((st[k].shape[-2], st[k].shape[-1]) for k in ("state_drones", "cylinders"))


def phase_option_kernels(dev) -> dict:
    """Rows 2 (`encoder_forward`) and 5 (`encoder_backward`) at phase 12's
    specs, each against its plain version (phase 2's limits and f32
    controls), timed by CUDA events beside the bound."""
    from mupe_tpu_torch.ops import fused_encoder as fe

    gen = torch.Generator().manual_seed(12)
    cases = {"per-agent actor": (fe.EncoderSpec(groups=GROUPS, head_dim=4), OPT_ROWS),
             "critic": (fe.EncoderSpec(groups=GROUPS, head_dim=1), MB_ROWS),
             "state critic": (fe.EncoderSpec(groups=state_groups(), head_dim=3), OPT_ROWS)}
    log("[12] rows 2 and 5 at the options' specs vs their plain versions: "
        + "; ".join(f"{k} S={s} groups {sp.groups} head {sp.head_dim}"
                    for k, (sp, s) in cases.items()))
    out = {"encoder_forward": {}, "encoder_backward": {}}
    errs = {"encoder_forward": [], "encoder_backward": []}
    for what, (spec, s) in cases.items():
        leaves = random_leaves(fe.leaf_shapes(spec), gen, dev)
        x = (2.0 * torch.randn((s, spec.obs_dim), generator=gen)).to(dev)
        dout = torch.randn((s, spec.head_dim), generator=gen).to(dev)
        y = fe.encoder_forward(spec, leaves, x)
        (grads,) = fe.encoder_backward([(spec, leaves)], x, [dout])
        torch.cuda.synchronize()
        exact = in_f64(fe.reference_apply, spec, leaves, x)
        errs["encoder_forward"].append(compare(f"encoder_forward {what} S={s}", y,
                                               fe.reference_apply(spec, leaves, x),
                                               fe.KERNEL_TOL, exact))
        control(f"{what} S={s}", lambda **k: fe.reference_apply(spec, leaves, x, **k),
                fe.KERNEL_TOL, exact)
        exact_b = in_f64(fe.reference_backward, spec, leaves, x, dout)
        errs["encoder_backward"].append(bwd_compare(
            f"encoder_backward {what} S={s}", grads,
            fe.reference_backward(spec, leaves, x, dout), fe.BWD_KERNEL_TOL, exact_b))
        bwd_control(f"{what} backward S={s}",
                    lambda **k: fe.reference_backward(spec, leaves, x, dout, **k),
                    fe.BWD_KERNEL_TOL, fe.BWD_CONTROL_BLIND, exact_b)
        times = {
            "encoder_forward": (
                cuda_time_ms(lambda: fe.encoder_forward(spec, leaves, x), runs=10),
                cuda_time_ms(lambda: fe.reference_apply(spec, leaves, x), runs=10),
                bound(encoder_flops(spec, s), nbytes(x, *leaves) + s * spec.head_dim * 4)),
            "encoder_backward": (
                cuda_time_ms(lambda: fe.encoder_backward([(spec, leaves)], x, [dout]), runs=10),
                cuda_time_ms(lambda: fe.reference_backward(spec, leaves, x, dout), runs=5),
                bound(encoder_bwd_flops(spec, s), nbytes(x, dout) + 2 * nbytes(*leaves)))}
        for name, (ms, plain, b) in times.items():
            log(f"  {name} {what} S={s}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
            out[name][what] = dict(rows=s, head=spec.head_dim, ms=ms, plain_ms=plain,
                                   bound_ms=b["bound_ms"], bound_by=b["bound_by"])
    return {name: dict(option_specs=v, option_max_abs_err=max(errs[name]))
            for name, v in out.items()}


def _net_leaves(net):
    """A network's leaves, or one list an agent for per-agent actors."""
    from mupe_tpu_torch.learning.mappo import AgentStack

    if isinstance(net, AgentStack):
        return [list(n.leaves) for n in net.nets]
    return list(net.leaves)


def clone_state(policy, ts, obs, state=None):
    """A learner state of `policy` (on its device) holding `ts`'s values."""
    return policy.init(obs, actor_leaves=_net_leaves(ts.actor), log_std=ts.log_std,
                       critic_leaves=_net_leaves(ts.critic),
                       tp_leaves=None if getattr(ts, "tp_net", None) is None
                       else list(ts.tp_net.leaves()),
                       **({} if state is None else {"state_example": state}))


def _unit_heads(ts) -> None:
    """Heads at unit gain (x100), so every term of the loss moves."""
    from mupe_tpu_torch.learning.mappo import AgentStack

    with torch.no_grad():
        for net in (ts.actor, ts.critic):
            for n in (net.nets if isinstance(net, AgentStack) else [net]):
                n.leaves[-2].mul_(100.0)


def hold_update(tag, new, metrics, rel=5e-3, param_atol=3e-3, flat_tol=1e-5) -> None:
    """The card's update (`new[dev]`, `metrics[dev]`) against the CPU's:
    metrics within `rel` relative (1e-2 for the gradient norms) + `flat_tol`,
    parameters within `param_atol`."""
    from mupe_tpu_torch.learning.mappo import net_flats

    (dev_c, (ts_c, m_c)), (dev_g, (ts_g, m_g)) = sorted(
        zip(new, zip(new.values(), metrics.values())), key=lambda kv: kv[0] != "cpu")
    worst = max((abs(m_g[k] - m_c[k]) / max(abs(m_c[k]), 1e-5), k) for k in m_c)
    log(f"  {tag} card vs CPU update metrics: worst relative difference {worst[0]:.3e} "
        f"({worst[1]})")
    for k, v in m_c.items():
        r = 1e-2 if k.endswith("grad_norm") else rel
        if not abs(m_g[k] - v) <= r * abs(v) + flat_tol:
            raise AssertionError(f"{tag}: card and CPU updates disagree on {k}: {m_g[k]} vs {v}")
    pairs = {"actor": list(zip(net_flats(ts_g.actor), net_flats(ts_c.actor)))
             + [(ts_g.log_std, ts_c.log_std)],
             "critic": list(zip(net_flats(ts_g.critic), net_flats(ts_c.critic)))}
    errs = {n: max(float((g.detach().cpu() - c.detach()).abs().max()) for g, c in p)
            for n, p in pairs.items()}
    log(f"  {tag} card vs CPU parameters: " + ", ".join(
        f"{k} max_abs_err={v:.3e}" for k, v in errs.items()) + f" (tol {param_atol:g})")
    if not max(errs.values()) <= param_atol:
        raise AssertionError(f"{tag}: card and CPU updates disagree on the parameters")


def check_option_update_against_cpu(dev, **algo) -> None:
    """One `train_op` of a MAPPO option on the card against the CPU from the
    same batch, parameters and permutation: 16 arenas x 8 steps of a CPU
    rollout (phase 4's), heads at unit gain, 2 minibatches, 1 epoch; phase
    4's tolerances (metrics 5e-3 relative, gradient norms 1e-2, parameters
    3e-3)."""
    from mupe_tpu_torch.envs import HideAndSeek, HideAndSeekCfg, tree_to
    from mupe_tpu_torch.learning import MAPPOCfg, MAPPOPolicy, init_carry, make_rollout

    env = HideAndSeek(HideAndSeekCfg(num_envs=16, max_episode_length=800), device="cpu")
    cfg = MAPPOCfg(train_every=8, num_minibatches=2, ppo_epochs=1, use_tp_net=True, **algo)
    pols = {d: MAPPOPolicy(cfg, 3, 4, obs_is_dict=True, tp_input_dim=env.cfg.tp_input_dim,
                           device=d) for d in ("cpu", dev)}
    carry = init_carry(env, pols["cpu"], torch.Generator().manual_seed(9))
    _unit_heads(carry.ts)
    ts_g = clone_state(pols[dev], carry.ts, tree_to(carry.obs, dev))
    carry, traj, _ = make_rollout(env, pols["cpu"])(carry)
    ts_c = clone_state(pols["cpu"], carry.ts, carry.obs)
    ts_g = clone_state(pols[dev], ts_c, tree_to(carry.obs, dev))
    perms = torch.randperm(16 * 8, generator=torch.Generator().manual_seed(10))[None]
    new, metrics = {}, {}
    for d, ts in (("cpu", ts_c), (dev, ts_g)):
        new[d], m = pols[d].train_op(ts, tree_to(traj, d), tree_to(carry.obs, d), perms=perms)
        metrics[d] = {k: float(v) for k, v in m.items()}
    hold_update(f"MAPPO {algo}", new, metrics)


class Launches:
    """Launches of the named kernel wrappers (every wrapper by default)
    since `reset()`, read from the kernel spans' counts of
    `mupe_tpu_torch/utils/trace.py`."""

    def __init__(self, *names: str):
        self.names = names or tuple(KERNEL_SPANS)
        self.reset()

    def _now(self) -> dict:
        counts = trace.counts()
        return {n: sum(counts[s] for s in KERNEL_SPANS[n]) for n in self.names}

    def reset(self) -> None:
        self.base = self._now()

    def read(self) -> dict:
        return {n: v - self.base[n] for n, v in self._now().items()}


def _train_finite(tag, train_iter, carry, iters):
    """`iters` iterations; every metric and parameter finite."""
    carry, metrics, ep_stats = run_train_iters(train_iter, carry, iters)
    _check_finite(tag, carry, metrics, ep_stats, iters)
    return carry


def _check_finite(tag, carry, metrics, ep_stats, iters) -> None:
    from mupe_tpu_torch.learning.mappo import net_flats

    params = net_flats(carry.ts.actor) + net_flats(carry.ts.critic) + [carry.ts.log_std]
    if not (_all_finite(metrics) and _all_finite(ep_stats)
            and all(bool(torch.isfinite(p).all()) for p in params)):
        raise AssertionError(f"{tag}: non-finite metric or parameter after training")
    log(f"  {tag}: {iters} iterations, finite; " + ", ".join(
        f"{k}={float(v):.5g}" for k, v in sorted(metrics.items())))


def phase_options(dev) -> dict:
    """Phase 12, HideAndSeek at bench.py's width: per-agent actors (launches
    counted), the relation encoders and the transformer (finite),
    the state critic's refusal, and the state critic at policy level.
    Returns the kernels' launches per iteration of the share_actor=False
    run."""
    from mupe_tpu_torch import harness
    from mupe_tpu_torch.envs import HideAndSeek, HideAndSeekCfg, tree_to
    from mupe_tpu_torch.learning import init_carry, make_rollout, make_train_iter

    wrappers = Launches("encoder_forward", "encoder_pair_forward", "encoder_backward",
                        "weight_grads", "tp_forward", "tp_backward")
    log(f"[12] MAPPO share_actor=False: make_train_iter, HideAndSeek {NUM_ENVS} arenas x "
        f"{STEPS} steps, bench.py's MAPPOCfg (TP net on), {OPT_ITERS} iterations")
    env, policy = make_slice(dev, NUM_ENVS, 800, share_actor=False)
    carry = init_carry(env, policy, torch.Generator(device=dev).manual_seed(12))
    wrappers.reset()
    carry, metrics, ep_stats = run_train_iters(make_train_iter(env, policy), carry, OPT_ITERS)
    per_iter = {k: v / OPT_ITERS for k, v in wrappers.read().items()}
    log(f"  launches per iteration: {per_iter}")
    n = 3
    want = {"encoder_forward": STEPS * (n + 1) + 1 + 4 * 16 * (n + 1),
            "encoder_backward": 4 * 16 * (n + 1), "encoder_pair_forward": 0}
    if (any(per_iter[k] != v for k, v in want.items()) or per_iter["tp_forward"] < STEPS + 1
            or per_iter["tp_backward"] < 1 or per_iter["weight_grads"] != per_iter[
                "encoder_backward"]):
        raise AssertionError(f"share_actor=False skipped a kernel or took another: {per_iter}, "
                             f"want {want}")
    _check_finite("share_actor=False", carry, metrics, ep_stats, OPT_ITERS)
    check_option_update_against_cpu(dev, share_actor=False)

    for encoder in ("RelationEncoder", "PartialRelationEncoder"):
        env_r, pol_r = make_slice(dev, NUM_ENVS, 800, attn_encoder=encoder)
        carry_r = init_carry(env_r, pol_r, torch.Generator(device=dev).manual_seed(13))
        _train_finite(f"attn_encoder={encoder}", make_train_iter(env_r, pol_r), carry_r,
                      OPT_ITERS)
    env_t, pol_t, _, _ = harness.build("HideAndSeek", {"num_envs": NUM_ENVS,
                                                       "max_episode_length": 800},
                                       {"train_every": STEPS}, algo="transformer", device=dev)
    carry_t = init_carry(env_t, pol_t, torch.Generator(device=dev).manual_seed(14))
    _train_finite("algo=transformer", make_train_iter(env_t, pol_t), carry_t, OPT_ITERS)

    # the state critic on HideAndSeek is refused, as the JAX package fails on it
    env_s, pol_s = make_slice(dev, 16, 800, critic_input="state")
    try:
        init_carry(env_s, pol_s, torch.Generator(device=dev).manual_seed(15))
    except ValueError as e:
        if "state_drones" not in str(e):
            raise
        log(f"  critic_input='state' on HideAndSeek refused: {e}")
    else:
        raise AssertionError("critic_input='state' on HideAndSeek was not refused")

    # the state critic at policy level, over a well-formed state of
    # HideAndSeek's widths from real observations
    log(f"  critic_input='state' at policy level: {NUM_ENVS} arenas x {STEPS} steps of "
        f"HideAndSeek, its critic state's cylinders cut to [E, k, 5]")
    env_p, pol_p = make_slice(dev, NUM_ENVS, 800, critic_input="state")
    wenv = WellFormedStateEnv(env_p)
    carry_p = init_carry(wenv, pol_p, torch.Generator(device=dev).manual_seed(16))
    carry_p, traj, _ = make_rollout(wenv, pol_p)(carry_p)
    # act, card vs CPU, on every arena of one step
    pol_c = type(pol_p)(pol_p.cfg, 3, 4, obs_is_dict=True, tp_input_dim=env_p.cfg.tp_input_dim,
                        device="cpu")
    obs0 = {k: v[0] for k, v in traj["obs"].items()}
    st0 = {k: v[0] for k, v in traj["state"].items()}
    ts_c = clone_state(pol_c, carry_p.ts, tree_to(obs0, "cpu"), tree_to(st0, "cpu"))
    noise = torch.randn((NUM_ENVS, 3, 4), generator=torch.Generator().manual_seed(17))
    out = {"cpu": pol_c.act(ts_c, tree_to(obs0, "cpu"), noise=noise, state=tree_to(st0, "cpu")),
           dev: pol_p.act(carry_p.ts, obs0, noise=noise.to(dev), state=st0)}
    for i, what in enumerate(("action", "logp", "value")):
        err = float((out[dev][i].cpu() - out["cpu"][i]).abs().max())
        scale = float(out["cpu"][i].abs().max())
        log(f"  state critic act {what}: card vs CPU max_abs_err={err:.3e} (scale {scale:.3e}, "
            f"tol 3e-2 of it: phase 11's bf16 limit)")
        if not err <= 3e-2 * scale:
            raise AssertionError(f"state critic act: card and CPU disagree on {what}")
    # train_op on the card over the whole batch (bench.py's minibatches)
    wrappers.reset()
    new_p, m_p = pol_p.train_op(carry_p.ts, traj, carry_p.obs, last_state=carry_p.state)
    torch.cuda.synchronize()
    took = wrappers.read()
    log(f"  state critic train_op on the card ({NUM_ENVS} x {STEPS}): launches {took}")
    if took["encoder_forward"] < 1 + 2 * 4 * 16 or took["encoder_backward"] != 2 * 4 * 16:
        raise AssertionError(f"the state critic's update skipped a kernel: {took}")
    if not _all_finite(m_p):
        raise AssertionError("state critic: non-finite metric")
    # and card vs CPU on the first 64 arenas of that batch (2 minibatches)
    cut = min(64, NUM_ENVS)
    cfg = dataclasses.replace(pol_p.cfg, num_minibatches=2, ppo_epochs=1)
    pols = {d: type(pol_p)(cfg, 3, 4, obs_is_dict=True, tp_input_dim=env_p.cfg.tp_input_dim,
                           device=d) for d in ("cpu", dev)}
    sub = {k: (tree_to({kk: vv[:, :cut] for kk, vv in v.items()}, "cpu") if isinstance(v, dict)
               else v[:, :cut].cpu()) for k, v in traj.items() if k != "tp_input"}
    sub.pop("tp_gt"), sub.pop("tp_done")
    last = {k: v[:cut].cpu() for k, v in carry_p.obs.items()}
    last_st = {k: v[:cut].cpu() for k, v in carry_p.state.items()}
    # heads at unit gain, and the subset's actions drawn again under them, so
    # the batch is on-policy (as phase 4's rollout after scaling its heads)
    _unit_heads(ts_c)
    noise = torch.randn((STEPS, cut, 3, 4), generator=torch.Generator().manual_seed(19))
    sub["action"], sub["logp"], sub["value"] = pol_c.act(ts_c, sub["obs"], noise=noise,
                                                         state=sub["state"])
    perms = torch.randperm(STEPS * cut, generator=torch.Generator().manual_seed(18))[None]
    new, metrics = {}, {}
    for d in ("cpu", dev):
        ts = clone_state(pols[d], ts_c, tree_to(last, d), tree_to(last_st, d))
        new[d], m = pols[d].train_op(ts, tree_to(sub, d), tree_to(last, d), perms=perms,
                                     last_state=tree_to(last_st, d))
        metrics[d] = {k: float(v) for k, v in m.items()}
    hold_update("state critic", new, metrics)
    return per_iter


def _hover_cpu_check(tag, dev, algo, env_kw, algo_kw) -> None:
    """One `act` and one `train_op` of a PPO-family algorithm on the card
    against the CPU, teacher-forced: a CPU rollout of 16 arenas x 32 steps,
    then both devices from its trajectory and the same parameters and
    permutations.  Float32 networks on both: act within 1e-4 of its scale,
    phase 11's update bounds (metrics 1e-2 relative + 1e-4, parameters
    3e-3)."""
    from mupe_tpu_torch import harness
    from mupe_tpu_torch.envs import tree_to
    from mupe_tpu_torch.learning import (
        init_carry, init_rnn_carry, make_rnn_rollout, make_rollout)
    from mupe_tpu_torch.learning.registry import is_recurrent

    env_kw = dict(env_kw, num_envs=16, max_episode_length=HOVER_EPISODE)
    algo_kw = dict(algo_kw, train_every=HOVER_STEPS, num_minibatches=2, ppo_epochs=1)
    env, pol_c, _, _ = harness.build("Hover", env_kw, algo_kw, algo=algo, device="cpu")
    _, pol_g, _, _ = harness.build("Hover", env_kw, algo_kw, algo=algo, device=dev)
    rec = is_recurrent(pol_c)
    gen = torch.Generator().manual_seed(40)
    carry = (init_rnn_carry if rec else init_carry)(env, pol_c, gen)
    _unit_heads(carry.ts)
    carry, traj, _ = (make_rnn_rollout if rec else make_rollout)(env, pol_c)(carry)
    ts, obs = carry.ts, traj["obs"]
    first = {k: v[0] for k, v in obs.items()} if isinstance(obs, dict) else obs[0]
    noise = torch.randn((16, 1, 4), generator=torch.Generator().manual_seed(41))
    ts_g = pol_g.init(tree_to(first, dev), actor_leaves=list(ts.actor.leaves),
                      log_std=ts.log_std, critic_leaves=list(ts.critic.leaves))
    if rec:
        args = (traj["actor_rnn"][1], traj["critic_rnn"][1], traj["is_init"][1])
        first = obs[1]
        out = {"cpu": pol_c.act(ts, first, *args, noise=noise),
               dev: pol_g.act(ts_g, first.to(dev), *(a.to(dev) for a in args),
                              noise=noise.to(dev))}
    else:
        out = {"cpu": pol_c.act(ts, first, noise=noise),
               dev: pol_g.act(ts_g, tree_to(first, dev), noise=noise.to(dev))}
    for i, (g, c) in enumerate(zip(out[dev], out["cpu"])):
        err, scale = float((g.cpu() - c).abs().max()), float(c.abs().max())
        if not err <= 1e-4 * max(scale, 1.0):
            raise AssertionError(f"{tag} act output {i}: card and CPU disagree ({err} of {scale})")
    log(f"  {tag} act card vs CPU: max_abs_err " + ", ".join(
        f"{float((g.cpu() - c).abs().max()):.3e}" for g, c in zip(out[dev], out["cpu"])))
    n_rows = (HOVER_STEPS // min(getattr(pol_c.cfg, "train_seq_len", HOVER_STEPS),
                                 HOVER_STEPS)) * 16 if rec else HOVER_STEPS * 16
    perms = torch.randperm(n_rows, generator=torch.Generator().manual_seed(42))[None]
    new, metrics = {}, {}
    for d, pol, t in (("cpu", pol_c, ts), (dev, pol_g, ts_g)):
        t = pol.init(tree_to(first, d), actor_leaves=list(ts.actor.leaves), log_std=ts.log_std,
                     critic_leaves=list(ts.critic.leaves))
        if rec:
            new[d], m = pol.train_op(t, tree_to(traj, d), perms=perms)
        else:
            new[d], m = pol.train_op(t, tree_to(traj, d), tree_to(carry.obs, d), perms=perms)
        metrics[d] = {k: float(v) for k, v in m.items()}
    hold_update(tag, new, metrics, rel=1e-2, flat_tol=1e-4)


def phase_family(dev) -> None:
    """Phase 12, the PPO family: Hover at the drive recipe's width (1,024
    arenas x 32 steps) for ppo, ppo with the privileged branches (HOVER_DR),
    ppo_tconv and ppo_rnn, 2 iterations each through `harness.build`, and
    each one's act and update card vs CPU; ppo_sdf at policy level."""
    from mupe_tpu_torch import harness
    from mupe_tpu_torch.envs import tree_to
    from mupe_tpu_torch.learning import (
        init_carry, init_rnn_carry, make_rnn_train_iter, make_train_iter)
    from mupe_tpu_torch.learning.ppo import PPOSDFNavPolicy
    from mupe_tpu_torch.learning.registry import is_recurrent
    from mupe_tpu_torch.learning import MAPPOCfg

    cases = {"ppo": ("ppo", {}, {}),
             "ppo + privileged branches": ("ppo", HOVER_DR,
                                           {"priv_actor": True, "priv_critic": True}),
             "ppo_tconv": ("ppo_tconv", {"obs_history_len": 32}, {}),
             "ppo_rnn": ("ppo_rnn", {}, {"train_seq_len": 16})}
    log(f"[12] the PPO family on Hover: {HOVER_ENVS} arenas x {HOVER_STEPS} steps, "
        f"{FAMILY_ITERS} iterations each")
    for tag, (algo, env_kw, algo_kw) in cases.items():
        env, pol, _, _ = harness.build(
            "Hover", dict(env_kw, num_envs=HOVER_ENVS, max_episode_length=HOVER_EPISODE),
            dict(algo_kw, train_every=HOVER_STEPS, num_minibatches=HOVER_MINIBATCHES),
            algo=algo, device=dev)
        rec = is_recurrent(pol)
        carry = (init_rnn_carry if rec else init_carry)(
            env, pol, torch.Generator(device=dev).manual_seed(30))
        it = (make_rnn_train_iter if rec else make_train_iter)(env, pol)
        _train_finite(tag, it, carry, FAMILY_ITERS)
        _hover_cpu_check(tag, dev, algo, env_kw, algo_kw)

    log(f"  ppo_sdf at policy level: {SDF_ENVS * SDF_STEPS} rows x {SDF_POINTS} points, "
        f"act and train_op card vs CPU")
    g = torch.Generator().manual_seed(50)
    obs = {"observation": torch.randn((SDF_STEPS, SDF_ENVS, 1, 20), generator=g),
           "sdf_points": torch.randn((SDF_STEPS, SDF_ENVS, 1, SDF_POINTS, 3), generator=g)}
    last = {k: v[0] for k, v in obs.items()}
    cfg = MAPPOCfg(gamma=0.99, train_every=SDF_STEPS, num_minibatches=2, ppo_epochs=1)
    pols = {d: PPOSDFNavPolicy(cfg, device=d) for d in ("cpu", dev)}
    ts_c = pols["cpu"].init(last, torch.Generator().manual_seed(51))
    _unit_heads(ts_c)
    noise = torch.randn((SDF_STEPS, SDF_ENVS, 1, 4), generator=g)
    act_c = pols["cpu"].act(ts_c, obs, noise=noise)
    ts_g = clone_state(pols[dev], ts_c, tree_to(last, dev))
    act_g = pols[dev].act(ts_g, tree_to(obs, dev), noise=noise.to(dev))
    errs = [float((a.cpu() - b).abs().max()) for a, b in zip(act_g, act_c)]
    log("  ppo_sdf act card vs CPU: max_abs_err " + ", ".join(f"{e:.3e}" for e in errs))
    if not all(e <= 1e-4 * max(float(b.abs().max()), 1.0) for e, b in zip(errs, act_c)):
        raise AssertionError("ppo_sdf act: card and CPU disagree")
    traj = {"obs": obs, "action": act_c[0], "logp": act_c[1], "value": act_c[2],
            "reward": torch.randn((SDF_STEPS, SDF_ENVS, 1, 1), generator=g),
            "done": torch.rand((SDF_STEPS, SDF_ENVS, 1), generator=g) < 0.1}
    perms = torch.randperm(SDF_STEPS * SDF_ENVS, generator=torch.Generator().manual_seed(52))[None]
    new, metrics = {}, {}
    for d in ("cpu", dev):
        ts = clone_state(pols[d], ts_c, tree_to(last, d))
        new[d], m = pols[d].train_op(ts, tree_to(traj, d), tree_to(last, d), perms=perms)
        metrics[d] = {k: float(v) for k, v in m.items()}
    hold_update("ppo_sdf", new, metrics, rel=1e-2, flat_tol=1e-4)


# phase 13: ppo_vision, the depth camera, RMA and the ring buffer at Hover's
# default width (4,096 arenas, the drive recipe's 32 steps and 8 minibatches)
VISION_ENVS = 4096
VISION_ITERS = 2
VISION_MB_FRAMES = VISION_ENVS * HOVER_STEPS // HOVER_MINIBATCHES  # 16,384
DEPTH_BIG = (64, 48)                          # DepthCameraCfg's own default size
DEPTH_TOL, DEPTH_OVER_SHARE = 1e-5, 1e-4      # frame / metres; share of pixels past it
RMA_ITERS = 8                                 # phases of 4, 2 and 2 iterations
BUFFER_L, BUFFER_WINDOWS, BUFFER_SEQ = 128, 4096, 16


def _vision_train(dev, kind: str) -> None:
    """ppo_vision with backbone `kind` on Hover's depth camera at 4,096 x 32:
    VISION_ITERS iterations, every metric and parameter finite."""
    from mupe_tpu_torch import harness
    from mupe_tpu_torch.learning import init_carry, make_train_iter

    env, pol, _, _ = harness.build(
        "Hover", dict(num_envs=VISION_ENVS, max_episode_length=HOVER_EPISODE, obs_depth=True),
        dict(train_every=HOVER_STEPS, num_minibatches=HOVER_MINIBATCHES, vision_encoder=kind),
        algo="ppo_vision", device=dev)
    carry = init_carry(env, pol, torch.Generator(device=dev).manual_seed(60))
    _train_finite(f"ppo_vision {kind}", make_train_iter(env, pol), carry, VISION_ITERS)


def _mobilenet_large_check(dev) -> None:
    """MobileNetV3-Large forward and backward on one update minibatch of
    Hover's frames (16,384 of 24 x 32), card vs CPU.  Its
    batch-statistics norms over 16,384 x H x W values make float32's own
    rounding large (the gradients' float32 sat up to 8% of their scale from
    float64 on either device), so each tensor's floor is the CPU's float32
    error against the card's float64, and the card's float32 is held within
    2x that floor (+ 1e-6 of the scale) of the CPU's."""
    from mupe_tpu_torch.learning.modules import mobilenet, networks

    mod = mobilenet.MobileNetV3("enc", "large")
    specs = mod.leaf_specs(1)
    gen = torch.Generator().manual_seed(61)
    leaves = [networks.init_leaf(l, gen) for l in specs]
    x = torch.rand((VISION_MB_FRAMES, 24, 32, 1), generator=gen)
    cot = torch.randn((VISION_MB_FRAMES, mod.out_dim), generator=gen)

    def run(d, dtype=torch.float32):
        p = {l.path: v.to(d, dtype).requires_grad_(True) for l, v in zip(specs, leaves)}
        xd = x.to(d, dtype).requires_grad_(True)
        out = mod(p, xd)
        return [out, *torch.autograd.grad(torch.sum(out * cot.to(d, dtype)), [xd, *p.values()])]

    got = [t.detach().cpu() for t in run(dev)]
    ref = [t.detach().cpu() for t in run(dev, torch.float64)]
    want = run("cpu")
    ratio, floor_share = 0.0, 0.0
    net_scale = max(float(r.abs().max()) for r in ref[2:])
    for i, (g, r, c) in enumerate(zip(got, ref, want)):
        g, c = g.double(), c.detach().double()
        scale = float(r.abs().max())
        floor = float((c - r).abs().max())
        err = float((g - c).abs().max())
        ratio = max(ratio, err / max(floor, 1e-30))
        if scale >= 1e-6 * net_scale:  # not a gradient of rounding noise
            floor_share = max(floor_share, floor / scale)
        if not err <= 2 * floor + 1e-6 * scale:
            raise AssertionError(f"mobilenet_v3_large tensor {i}: card and CPU disagree ({err}; "
                                 f"the CPU's float32 error {floor}, scale {scale})")
    log(f"  mobilenet_v3_large forward + backward on {VISION_MB_FRAMES} frames of 24 x 32: card "
        f"vs CPU at most {ratio:.3f}x the CPU float32's own error against float64 (tol 2x), "
        f"which reached {floor_share:.3e} of a tensor's scale")


def _depth_checks(dev) -> None:
    """Hover's depth frame at 4,096 arenas card vs CPU (from the same states,
    after steps), and the full scene (arena wall, ceiling, 6 cylinders, the
    target) at 4,096 cameras of 64 x 48; pixels past DEPTH_TOL counted and
    bounded (grazing rays)."""
    from mupe_tpu_torch.envs import Hover, HoverCfg, tree_to
    from mupe_tpu_torch.sensors import depth

    env_c = Hover(HoverCfg(num_envs=VISION_ENVS, obs_depth=True), device="cpu")
    env_g = Hover(HoverCfg(num_envs=VISION_ENVS, obs_depth=True), device=dev)
    gen = torch.Generator().manual_seed(62)
    state = env_c.reset(gen)
    for _ in range(5):
        state, _ = env_c.step(state, torch.rand((VISION_ENVS, 1, 4), generator=gen) * 2 - 1, gen)
    want = env_c.observe(state)["depth"]
    got = env_g.observe(tree_to(state, dev))["depth"].cpu()
    over = int(((got - want).abs() > DEPTH_TOL).sum())
    log(f"  Hover's depth frame {tuple(want.shape)} card vs CPU: max_abs_err "
        f"{float((got - want).abs().max()):.3e}, {over} of {want.numel()} pixels past "
        f"{DEPTH_TOL:g} (bound {DEPTH_OVER_SHARE:g} of them)")
    if over > DEPTH_OVER_SHARE * want.numel():
        raise AssertionError(f"Hover's depth frame: {over} pixels past {DEPTH_TOL}")
    w, h = DEPTH_BIG
    cfg = depth.DepthCameraCfg(width=w, height=h, max_range=10.0)
    pos = torch.stack([torch.rand(VISION_ENVS, generator=gen) * 4 - 2,
                       torch.rand(VISION_ENVS, generator=gen) * 4 - 2,
                       torch.rand(VISION_ENVS, generator=gen) * 2 + 0.3], dim=-1)
    quat = torch.nn.functional.normalize(torch.randn((VISION_ENVS, 4), generator=gen), dim=-1)
    cyl = torch.rand((VISION_ENVS, 6, 3), generator=gen) * 6 - 3
    cyl[..., 2] = torch.where(torch.rand((VISION_ENVS, 6), generator=gen) < 0.3, -1.0, 0.0)
    tgt = torch.rand((VISION_ENVS, 3), generator=gen) * 4 - 2

    def scene(d):
        return depth.depth_image(cfg, pos.to(d), quat.to(d), cylinders=cyl.to(d),
                                 arena_size=4.0, max_height=3.0, target_pos=tgt.to(d),
                                 target_radius=0.25)

    want, got = scene("cpu"), scene(dev).cpu()
    over = int(((got - want).abs() > DEPTH_TOL * want.abs()).sum())
    log(f"  depth_image, wall + ceiling + 6 cylinders + target, {VISION_ENVS} cameras of "
        f"{w} x {h}: card vs CPU {over} of {want.numel()} pixels past {DEPTH_TOL:g} relative "
        f"(bound {DEPTH_OVER_SHARE:g} of them)")
    if over > DEPTH_OVER_SHARE * want.numel():
        raise AssertionError(f"depth_image: {over} pixels past {DEPTH_TOL} relative")


def _rma_train(run_dir: str) -> None:
    """`python -m mupe_tpu_torch.train task=Hover algo=ppo_adapt max_iters=8`
    (its `train`, on the card): the last row phase 3, every logged value
    finite."""
    from mupe_tpu_torch.harness import train

    argv = ["task=Hover", "algo=ppo_adapt", f"max_iters={RMA_ITERS}",
            f"algo.train_every={HOVER_STEPS}", f"algo.num_minibatches={HOVER_MINIBATCHES}",
            "log_interval=1", f"run_dir={run_dir}", "run_name=rma"]
    last = train(argv)
    with open(Path(run_dir) / "rma" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    if last["rma_phase"] != 3.0 or [float(r["rma_phase"]) for r in rows] != [1.0] * 4 + [
            2.0] * 2 + [3.0] * 2:
        raise AssertionError(f"RMA's phases: {[r['rma_phase'] for r in rows]}")
    bad = [(i, k) for i, r in enumerate(rows) for k, v in r.items()
           if v != "" and not math.isfinite(float(v))]
    if bad:
        raise AssertionError(f"RMA: non-finite logged values {bad}")
    log(f"  RMA last row: " + ", ".join(f"{k}={v:.5g}" for k, v in sorted(last.items())
                                         if not k.startswith("stats/")))


def _adaptation_checks(dev) -> None:
    """`update_adaptation` card vs CPU for each of the six losses on one
    phase-2 batch (4,096 arenas x 32 steps of the phase-2 policy's rollout on
    the card), from the same parameters: the loss(es) within 1e-4 relative,
    the new parameters within 2 adaptation_lr (a gradient within rounding of
    zero takes Adam's first step either way) + 1e-5 of their scale."""
    from mupe_tpu_torch import harness
    from mupe_tpu_torch.envs import tree_to
    from mupe_tpu_torch.learning import init_carry, make_rollout
    from mupe_tpu_torch.learning.optim import AdamState
    from mupe_tpu_torch.learning.ppo.ppo_adapt import ADAPTATION_LOSSES, LOG_STD_PATH

    env_kw = dict(harness.RMA_HOVER_DR, obs_history_len=harness.RMA_HOVER_HISTORY,
                  num_envs=VISION_ENVS, max_episode_length=HOVER_EPISODE)
    algo_kw = dict(train_every=HOVER_STEPS, phase="adaptation")
    env, pol, _, _ = harness.build("Hover", env_kw, algo_kw, algo="ppo_adapt", device=dev)
    carry = init_carry(env, pol, torch.Generator(device=dev).manual_seed(63))
    _, traj, _ = make_rollout(env, pol)(carry)
    obs = {k: v.reshape((-1,) + tuple(v.shape[3:])) for k, v in traj["obs"].items()}
    n = obs["observation"].shape[0]
    first = {k: v[:1, None] for k, v in obs.items()}
    gen = torch.Generator().manual_seed(64)
    p1 = harness.make_policy("ppo_adapt", env, {}, "cpu").init(tree_to(first, "cpu"), gen)
    frozen = {k: v.detach() for k, v in p1.actor.params().items()}
    frozen[LOG_STD_PATH] = torch.tensor([0.1, -0.2, 0.3, -0.4])
    critic = {k: v.detach() for k, v in p1.critic.params().items()}
    adapt = pol.adaptation_params(carry.ts).detach().cpu()
    for variant in ADAPTATION_LOSSES:
        out = {}
        for d in ("cpu", dev):
            pd = harness.make_policy("ppo_adapt", env, {"phase": "adaptation",
                                                        "adaptation_loss": variant}, d)
            disc, disc_opt = pd.init_discriminator(torch.Generator().manual_seed(65))
            a = adapt.to(d)
            args = [tree_to(x, d) for x in (frozen, obs, critic)]
            out[d] = pd.update_adaptation(
                a, AdamState.zeros_like([a]), args[0], args[1]["observation_h"],
                args[1]["intrinsics"], obs=args[1]["observation"], actor_params=args[0],
                critic_params=args[2], disc=disc, disc_opt=disc_opt)
        c, g = out["cpu"], out[dev]
        losses = [(float(g[i]), float(c[i])) for i in ((2, 5) if len(c) == 6 else (2,))]
        for lg, lc in losses:
            if not abs(lg - lc) <= 1e-4 * abs(lc) + 1e-7:
                raise AssertionError(f"update_adaptation {variant}: loss {lg} vs {lc}")
        params = [(g[0], c[0])] + ([(g[3], c[3])] if len(c) == 6 else [])
        errs = []
        for pg, pc in params:
            err = float((pg.cpu() - pc).abs().max())
            errs.append(err)
            if not err <= 2 * pol.adapt_cfg.adaptation_lr + 1e-5 * float(pc.abs().max()):
                raise AssertionError(f"update_adaptation {variant}: parameters {err}")
        log(f"  update_adaptation {variant} on {n} rows card vs CPU: loss(es) "
            + ", ".join(f"{lg:.6g} vs {lc:.6g}" for lg, lc in losses)
            + "; parameters max_abs_err " + ", ".join(f"{e:.3e}" for e in errs))


def _buffer_check(dev) -> None:
    """TrajRingBuffer at the rollout's shape (L = 128, E = 4,096, Hover's
    observation): five extends of 32 steps (160: past the seam), then 4,096
    windows of 16 steps with the same injected draws, card vs CPU exactly."""
    from mupe_tpu_torch.envs import tree_to
    from mupe_tpu_torch.learning import mybuffer

    gen = torch.Generator().manual_seed(66)
    obs_dim = 23                               # HoverCfg().obs_dim
    example = {"obs": torch.zeros((VISION_ENVS, 1, obs_dim)),
               "done": torch.zeros((VISION_ENVS, 1), dtype=torch.bool)}
    bufs = {d: mybuffer.TrajRingBuffer.create(tree_to(example, d), BUFFER_L)
            for d in ("cpu", dev)}
    for _ in range(5):
        chunk = {"obs": torch.randn((HOVER_STEPS, VISION_ENVS, 1, obs_dim), generator=gen),
                 "done": torch.rand((HOVER_STEPS, VISION_ENVS, 1), generator=gen) < 0.01}
        bufs = {d: mybuffer.extend(b, tree_to(chunk, d)) for d, b in bufs.items()}
    env_idx = torch.randint(0, VISION_ENVS, (BUFFER_WINDOWS,), generator=gen)
    t0 = torch.randint(0, BUFFER_L - BUFFER_SEQ, (BUFFER_WINDOWS,), generator=gen)
    out = {d: mybuffer.sample(b, BUFFER_WINDOWS, BUFFER_SEQ, env_idx=env_idx.to(d),
                              t0=t0.to(d)) for d, b in bufs.items()}
    (bc, vc), (bg, vg) = out["cpu"], out[dev]
    if not (int(bufs[dev].cursor) == int(bufs["cpu"].cursor) == 5 * HOVER_STEPS % BUFFER_L
            and bool(vg.all()) and torch.equal(vg.cpu(), vc)
            and all(torch.equal(bg[k].cpu(), bc[k]) for k in bc)):
        raise AssertionError("TrajRingBuffer: card and CPU differ")
    log(f"  TrajRingBuffer L={BUFFER_L} E={VISION_ENVS}: {5 * HOVER_STEPS} steps extended, "
        f"{BUFFER_WINDOWS} windows of {BUFFER_SEQ} steps identical card vs CPU")


def phase_vision_rma(dev) -> None:
    """Phase 13: ppo_vision (conv and MobileNetV3-Small) on Hover's depth
    camera at 4,096 x 32, each with one act and one update card vs CPU;
    MobileNetV3-Large forward + backward card vs CPU; the depth frame and
    the full scene card vs CPU; RMA's three phases through `train` and
    `update_adaptation`'s six losses card vs CPU; the ring buffer.  None of
    these paths launches a kernel of the port: the counts stay 0."""
    wrappers = Launches()
    log(f"[13] ppo_vision on Hover's depth camera (32 x 24): {VISION_ENVS} arenas x "
        f"{HOVER_STEPS} steps, {HOVER_MINIBATCHES} minibatches")
    for kind in ("conv", "mobilenet_v3_small"):
        _vision_train(dev, kind)
        _hover_cpu_check(f"ppo_vision {kind}", dev, "ppo_vision", {"obs_depth": True},
                         {"vision_encoder": kind})
    _mobilenet_large_check(dev)
    _depth_checks(dev)
    log(f"[13] RMA (algo=ppo_adapt) on Hover: {VISION_ENVS} arenas x {HOVER_STEPS} steps, "
        f"{RMA_ITERS} iterations")
    with tempfile.TemporaryDirectory() as run_dir:
        _rma_train(run_dir)
    _adaptation_checks(dev)
    _buffer_check(dev)
    launched = {k: v for k, v in wrappers.read().items() if v}
    if launched:
        raise AssertionError(f"phase 13's paths launched kernels: {launched}")
    log(f"  phase 13 launched none of the port's {len(wrappers.names)} kernel wrappers")


# phase 14: data parallelism over the arena axis (torch.distributed)
DP_WORKER_FLAG = "--dp-worker"
DP_TIMEOUT = 420                   # seconds a phase-14 worker may take
DP_MODES = (None, "fwdloss", "agrad")
DP_TRAJ_KEYS = ("action", "logp", "value", "reward", "done")
DP_SEED = 7
DP_TRAJ_REL = 1e-5                 # of a field's scale, ranks' rows against the one rank's
DP_GRAD_REL = 1e-4                 # the first steps' gradients, of each one's scale
# after the iteration's 64 Adam steps (16 minibatches x 4 epochs): a gradient
# that is rounding noise turns Adam's step of about lr = 5e-4 either way
DP_PARAM_ATOL = 2 * 64 * 5e-4


def _dp_argv(run_dir: str, name: str, iters: int) -> list:
    return [f"env.num_envs={NUM_ENVS}", f"algo.train_every={STEPS}", f"max_iters={iters}",
            "log_interval=1", "save_interval=-1", f"run_dir={run_dir}", f"run_name={name}",
            f"seed={DP_SEED}"]


def _dp_learner(ts) -> dict:
    """The learner's parameters and optimizer state on the CPU."""
    out = {"actor": ts.actor.flat.detach().cpu(), "critic": ts.critic.flat.detach().cpu(),
           "log_std": ts.log_std.detach().cpu()}
    out.update({f"tp{i}": l.detach().cpu() for i, l in enumerate(ts.tp_net.leaves())})
    for name in ("actor_opt", "critic_opt", "tp_opt"):
        out.update({f"{name}{i}": t.detach().cpu() for i, t in
                    enumerate(getattr(ts, name).tensors())})
    out["value_norm"] = torch.cat([ts.value_norm.running_mean, ts.value_norm.running_mean_sq,
                                   ts.value_norm.debiasing_term.reshape(1)]).cpu()
    return out


def _dp_digest(tensors: dict) -> torch.Tensor:
    """64 bits of a SHA-256 of the tensors' bytes, as an int64 [1]."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    return torch.tensor([int.from_bytes(h.digest()[:8], "little", signed=True)])


def _dp_same_on_ranks(what: str, tensors: dict) -> None:
    """Raise unless every rank holds the same bits (an all-gathered digest)."""
    from mupe_tpu_torch.parallel import dist

    digests = dist.all_gather_envs(_dp_digest(tensors))
    if not bool((digests == digests[0]).all()):
        raise AssertionError(f"{what}: the ranks' bits differ ({digests.tolist()})")


def _dp_iteration(dev, mode, shard_note: str) -> tuple:
    """One training iteration of bench.py's configuration from seed DP_SEED
    through `harness.build` (this rank's arenas of the group): (the
    trajectory's small fields on the CPU, the learner)."""
    import mupe_tpu_torch.learning.mappo as tmappo
    from mupe_tpu_torch import harness
    from mupe_tpu_torch.learning import init_carry
    from mupe_tpu_torch.learning.rollout import make_rollout

    algo = {"train_every": STEPS}
    if mode is not None:
        algo.update(use_inkernel_loss=True, direct_mode=mode)
    env, policy, _, _ = harness.build("HideAndSeek", {"num_envs": NUM_ENVS}, algo, device=dev)
    carry = init_carry(env, policy, torch.Generator(device=dev).manual_seed(DP_SEED))

    # the gradients of the first optimizer steps: the TP step, the first
    # minibatch's actor and critic
    first, real = [], tmappo.adam_updates

    def recording(grads, state, lr, **kw):
        if len(first) < 3:
            first.append([g.detach().cpu() for g in grads])
        return real(grads, state, lr, **kw)

    tmappo.adam_updates = recording
    try:
        carry, traj, _ = make_rollout(env, policy)(carry)
        _, metrics = policy.train_op(carry.ts, traj, carry.obs, carry.generator, shard=env.shard)
    finally:
        tmappo.adam_updates = real
    if not all(math.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError(f"{shard_note} mode {mode}: non-finite metrics")
    small = {k: traj[k].detach().float().cpu() for k in DP_TRAJ_KEYS}
    learner = _dp_learner(carry.ts)
    learner.update({f"grad{i}_{j}": g for i, gs in enumerate(first) for j, g in enumerate(gs)})
    return small, learner


def dp_worker(argv) -> int:
    """A rank of phase 14 (`chip_smoke.py --dp-worker ROLE RANK WORLD
    BACKEND INIT_METHOD OUT_DIR`): "one" runs world size 1, without and
    then with a process group; "two" is one of two ranks sharing the card."""
    from mupe_tpu_torch import harness
    from mupe_tpu_torch.parallel import dist
    from mupe_tpu_torch.utils.checkpoint import load_checkpoint

    role, rank, world, backend, init_method, out_dir = argv
    rank, world, out = int(rank), int(world), Path(out_dir)
    if role.startswith("fam"):
        return _fam_worker(role, rank, world, backend, init_method, out)
    if role == "video":
        return _video_worker(rank, world, backend, init_method, out)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    report = {"role": role, "rank": rank}
    if role == "one":
        # check 1: harness.train without a group, then with an NCCL group of one
        learners = {}
        for name in ("nogroup", "group"):
            if name == "group":
                dist.init_distributed(backend=backend, init_method=init_method,
                                      world_size=world, rank=rank)
                report["backend"] = torch.distributed.get_backend()
            harness.train(_dp_argv(str(out / "runs"), name, 2), default_task="HideAndSeek",
                          device=dev)
            learners[name] = load_checkpoint(out / "runs" / name / "checkpoints")
        same = _equal_trees(learners["nogroup"], learners["group"])
        report["harness_bits_equal"] = same
        if not same:
            raise AssertionError("world size 1: the learner with a group differs from without")
    else:
        dist.init_distributed(backend=backend, init_method=init_method, world_size=world,
                              rank=rank)
    note = f"{role} rank {rank}/{world}"
    for mode in DP_MODES:
        all_kernels = Launches()
        small, learner = _dp_iteration(dev, mode, note)
        report[f"launches_{mode}"] = {k: v for k, v in all_kernels.read().items() if v}
        if role == "two":
            _dp_same_on_ranks(f"{note} learner, mode {mode}", learner)
        torch.save({"traj": small, "learner": learner}, out / f"{role}_{rank}_{mode}.pt")
    if role == "two":
        # check 3: AEG through one closed cycle (phase 5's cuts), each rank its arenas
        fps_launches = Launches("farthest_point_sampling")
        algo = {"train_every": STEPS}
        env_kw = {"num_envs": NUM_ENVS, "max_episode_length": AEG_EPISODE,
                  "buffer_length": AEG_BUFFER, "use_init_easy_cases": True, "r_min": 0.0}
        env, policy, _, _ = harness.build("HideAndSeek_envgen", env_kw, algo, device=dev)
        from mupe_tpu_torch.learning import init_carry, make_train_iter

        carry = init_carry(env, policy, torch.Generator(device=dev).manual_seed(DP_SEED))
        carry, metrics, ep = make_train_iter(env, policy)(carry)
        gb = carry.env_state.gen
        report["aeg_fps_launches"] = fps_launches.read()["farthest_point_sampling"]
        report["aeg_history_len"] = int(gb.history_len)
        if report["aeg_fps_launches"] < 1 or int(gb.history_len) != AEG_BUFFER:
            raise AssertionError(f"{note}: AEG closed no cycle on the FPS path "
                                 f"({report['aeg_fps_launches']} launches)")
        _dp_same_on_ranks(f"{note} GenBuffer", {f.name: getattr(gb, f.name).cpu() for f in
                                                dataclasses.fields(gb)})
        # check 4: Hover's flat MAPPO through harness.train
        m = harness.train([f"env.num_envs={HOVER_ENVS}", "env.max_episode_length=300",
                           f"algo.train_every={HOVER_STEPS}",
                           f"algo.num_minibatches={HOVER_MINIBATCHES}", "max_iters=2",
                           "log_interval=1", "save_interval=-1",
                           f"run_dir={out / 'runs'}", "run_name=hover"],
                          default_task="Hover", device=dev)
        losses = torch.tensor([m["policy_loss"], m["value_loss"]], dtype=torch.float64)
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"{note}: Hover's losses {losses.tolist()}")
        _dp_same_on_ranks(f"{note} Hover's losses", {"losses": losses})
        report["hover_losses"] = losses.tolist()
    (out / f"report_{role}_{rank}.json").write_text(json.dumps(report))
    dist.destroy()
    return 0


def _dp_launch(role: str, world: int, backend: str, out: Path, phase: int = 14) -> list:
    """Run `world` workers of `role` (phase 14's, 15's or 16's); every wait
    bounded, every child killed on the way out.  Returns their reports."""
    store = out / f"store_{role}"
    threads = os.cpu_count() or 1  # shared by the ranks: no oversubscription
    # the workers share the card with this process: hand them the blocks
    # its earlier phases cached
    torch.cuda.empty_cache()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), DP_WORKER_FLAG,
                               role, str(r), str(world), backend, f"file://{store}", str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=dict(os.environ, LOCAL_RANK="0",
                                       OMP_NUM_THREADS=str(max(1, threads // world))))
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DP_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"[{phase}] {role} rank {r} exited {p.returncode}:\n"
                                 f"{text[-6000:]}")
    return [json.loads((out / f"report_{role}_{r}.json").read_text()) for r in range(world)]


def phase_parallel(card: str) -> None:
    """Phase 14: data parallelism over the arena axis at bench.py's width
    (4,096 arenas x 64 steps, TP net), in worker processes (this process
    holds no process group).  1: world size 1 over NCCL through
    `harness.train`, 2 iterations, the learner's bits equal to the same run
    without a group; 2: two ranks sharing the card over gloo (CUDA tensors,
    2,048 arenas each), one iteration on the default path and in each
    `direct_mode`, the ranks' learners bit-identical (an all-gathered
    digest), the joined trajectory and the learner held against the one
    rank's same iteration; 3: AEG at 2 ranks (phase 5's cuts) through one
    closed cycle, the buffer's bits equal on the ranks, each rank an FPS
    launch; 4: Hover's flat MAPPO at 2 ranks through `harness.train`."""
    t0 = time.perf_counter()
    log(f"[14] data parallelism: bench.py's configuration ({NUM_ENVS} arenas x {STEPS} steps, "
        f"TP net) at world size 1 over NCCL, and at 2 ranks sharing the card over gloo")
    torch.cuda.empty_cache()
    log(f"  this process keeps {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved of the card for the workers")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        (one,) = _dp_launch("one", 1, "nccl", out)
        log(f"  [1] world size 1: harness.train with an NCCL group ({one['backend']}) = without "
            f"a group, bit for bit: {one['harness_bits_equal']}")
        two = _dp_launch("two", 2, "gloo", out)
        for mode in DP_MODES:
            ref = torch.load(out / f"one_0_{mode}.pt", weights_only=True)
            parts = [torch.load(out / f"two_{r}_{mode}.pt", weights_only=True) for r in range(2)]
            worst = 0.0
            for k in DP_TRAJ_KEYS:
                joined = torch.cat([p["traj"][k] for p in parts], dim=1)
                want = ref["traj"][k]
                err = float((joined - want).abs().max()) / max(1.0, float(want.abs().max()))
                worst = max(worst, err)
                if joined.shape != want.shape or err > DP_TRAJ_REL:
                    raise AssertionError(f"[14] mode {mode}: trajectory field {k} of the 2 "
                                         f"ranks off the one rank's by {err:.3e} of its scale")
            got, want = parts[0]["learner"], ref["learner"]
            gerr = max(float((got[k] - want[k]).abs().max()) / float(want[k].abs().max())
                       for k in want if k.startswith("grad"))
            perr = max(float((got[k] - want[k]).abs().max())
                       for k in ("actor", "critic", "log_std", "tp0", "tp1", "tp2", "tp3", "tp4"))
            if gerr > DP_GRAD_REL or perr > DP_PARAM_ATOL:
                raise AssertionError(f"[14] mode {mode}: the 2 ranks' first gradients are "
                                     f"{gerr:.3e} of their scale off the one rank's (limit "
                                     f"{DP_GRAD_REL}), their parameters {perr:.3e} (limit "
                                     f"{DP_PARAM_ATOL})")
            log(f"  [2] mode {mode or 'default'}: ranks bit-identical; trajectory within "
                f"{worst:.3e} of each field's scale of the one rank's (limit {DP_TRAJ_REL}); "
                f"the first TP, actor and critic gradients within {gerr:.3e} of their scale "
                f"(limit {DP_GRAD_REL}), the parameters after the iteration within {perr:.3e} "
                f"(limit {DP_PARAM_ATOL}); launches a rank {two[0][f'launches_{mode}']}, "
                f"one rank {one[f'launches_{mode}']}")
        log(f"  [3] AEG at 2 ranks: one closed cycle, FPS launches per rank "
            f"{[r['aeg_fps_launches'] for r in two]}, history {two[0]['aeg_history_len']}, "
            "buffers bit-identical")
        log(f"  [4] Hover's flat MAPPO at 2 ranks through harness.train: losses "
            f"{two[0]['hover_losses']} on both ranks")
    log(f"[14] phase 14 took {time.perf_counter() - t0:.1f} s on {card}")


# phase 15: the PPO family across ranks (A4b); the controllers, Dragon and the
# transport group (A5); the examples
FAM_ENVS, FAM_MOBILENET_ENVS = HOVER_ENVS, 256  # phase 12's 1,024 x 32; MobileNet at 256
FAM_CASES = {  # name: (algo, task, env overrides, algo overrides, arenas, steps)
    "ppo": ("ppo", "Hover", {}, {}, FAM_ENVS, HOVER_STEPS),
    "ppo_priv": ("ppo", "Hover", HOVER_DR, {"priv_actor": True, "priv_critic": True},
                 FAM_ENVS, HOVER_STEPS),
    "ppo_tconv": ("ppo_tconv", "Hover", {"obs_history_len": 32}, {}, FAM_ENVS, HOVER_STEPS),
    "ppo_rnn": ("ppo_rnn", "Hover", {}, {"train_seq_len": 16}, FAM_ENVS, HOVER_STEPS),
    "transformer": ("transformer", "HideAndSeek", {}, {}, FAM_ENVS, HOVER_STEPS),
    "ppo_vision": ("ppo_vision", "Hover", {"obs_depth": True}, {}, FAM_ENVS, HOVER_STEPS),
    # 16 steps and 2 PPO epochs, cut from 32 and 4: gloo stages each of its
    # batch statistics' collectives through host memory (29-35 s an iteration
    # a rank at 32 steps and 4 epochs), and its gradients are noisy in f32
    # (PERF.md section 7), so Adam parts the learners by about lr a step
    "ppo_vision_mobilenet": ("ppo_vision", "Hover", {"obs_depth": True},
                             {"vision_encoder": "mobilenet_v3_small", "ppo_epochs": 2},
                             FAM_MOBILENET_ENVS, 16),
}
FAM_WORLD1 = {"ppo_rnn": ["task=Hover", "algo=ppo_rnn", "algo.train_seq_len=16"],
              "transformer": ["task=HideAndSeek", "algo=transformer"]}
FAM_WORLD1_STEPS = 8      # cut from 32 / 64 steps an iteration for the script's time
# HideAndSeek's capture and collision rewards are discrete: where cuBLAS's
# rounding, which depends on the batch, moves a drone across a threshold
# (a few 1e-7 of the scale), a reward flips, and the update learns from
# other data (measured: 1.3% of the entries, the learner 0.13 off).  So its
# trajectory is held at the first step and by the share of entries past
# DP_TRAJ_REL over the rollout, and its update replays the one rank's
# rollout (each rank its rows), under phase 14's bounds
FAM_FLIP_SHARE = 0.05
A5_ENVS, A5_CPU_ENVS, A5_SEED = NUM_ENVS, 64, 15
A5_TRAJ_ATOL = 1e-3       # metres, the card's first 64 arenas against the CPU's
EXAMPLES_TIMEOUT = 300


def _fam_iteration(dev, case: str, replay: "Path | None" = None,
                   keep: "Path | None" = None) -> tuple:
    """One iteration of `FAM_CASES[case]` from seed DP_SEED through
    `harness.build` on this rank's arenas: (the trajectory's small fields
    on the CPU, the learner and the first two optimizer steps' gradients on
    the CPU).  `keep` saves the rollout (the trajectory, the last
    observation, the generator's state) for a `replay`, whose rows of it
    this rank's update then takes in place of its own rollout's."""
    import mupe_tpu_torch.learning.mappo as tmappo
    import mupe_tpu_torch.learning.ppo.ppo_rnn as tppo_rnn
    from mupe_tpu_torch import harness
    from mupe_tpu_torch.learning import init_carry, init_rnn_carry
    from mupe_tpu_torch.learning.registry import is_recurrent
    from mupe_tpu_torch.learning.rollout import make_rnn_rollout, make_rollout
    from mupe_tpu_torch.utils.checkpoint import to_plain

    algo, task, env_kw, algo_kw, n_envs, steps = FAM_CASES[case]
    env_kw = dict(env_kw, num_envs=n_envs)
    if task == "Hover":
        env_kw["max_episode_length"] = HOVER_EPISODE
    env, pol, _, _ = harness.build(task, env_kw, dict(algo_kw, train_every=steps,
                                                      num_minibatches=HOVER_MINIBATCHES),
                                   algo=algo, device=dev)
    gen = torch.Generator(device=dev).manual_seed(DP_SEED)
    rec = is_recurrent(pol)
    carry = (init_rnn_carry if rec else init_carry)(env, pol, gen)
    carry, traj, _ = (make_rnn_rollout if rec else make_rollout)(env, pol)(carry)
    small = {k: traj[k].detach().float().cpu() for k in DP_TRAJ_KEYS}
    if keep is not None:
        torch.save({"traj": traj, "obs": carry.obs, "gen": gen.get_state()}, keep)
    if replay is not None:
        saved = torch.load(replay, weights_only=True)

        def rows(x, axis):
            if isinstance(x, dict):
                return {k: rows(v, axis) for k, v in x.items()}
            return env.shard.rows(x.to(dev), axis).contiguous()

        traj, carry.obs = rows(saved["traj"], 1), rows(saved["obs"], 0)
        gen.set_state(saved["gen"])
    first, real = [], tmappo.adam_updates

    def recording(grads, state, lr, **kw):
        if len(first) < 2:
            first.append([g.detach().cpu() for g in grads])
        return real(grads, state, lr, **kw)

    tmappo.adam_updates = tppo_rnn.adam_updates = recording
    try:
        if rec:
            ts, metrics = pol.train_op(carry.ts, traj, gen, shard=env.shard)
        else:
            ts, metrics = pol.train_op(carry.ts, traj, carry.obs, gen, last_state=carry.state,
                                       shard=env.shard)
    finally:
        tmappo.adam_updates = tppo_rnn.adam_updates = real
    if not all(math.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError(f"{case}: non-finite metrics")
    learner = {}

    def walk(x, path):
        if isinstance(x, torch.Tensor):
            if x.is_floating_point():
                learner[path] = x.detach().cpu()
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}/{k}")
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(v, f"{path}/{i}")

    walk(to_plain(ts), "ts")
    learner.update({f"grad{i}_{j}": g for i, gs in enumerate(first) for j, g in enumerate(gs)})
    return small, learner


def _fam_worker(role: str, rank: int, world: int, backend: str, init_method: str,
                out: Path) -> int:
    """A rank of phase 15 (`--dp-worker fam1|fam2 ...`): "fam1" runs world
    size 1, `harness.train` of ppo_rnn and transformer without and with an
    NCCL group of one, then each case's one-rank iteration; "fam2" is one of
    two ranks sharing the card, each case's iteration on its arenas."""
    from mupe_tpu_torch import harness
    from mupe_tpu_torch.parallel import dist
    from mupe_tpu_torch.utils.checkpoint import load_checkpoint

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    report = {"role": role, "rank": rank, "launches": {}}
    wrappers = Launches()
    if role == "fam1":
        # without a group, then with an NCCL group of one
        learners = {}
        for name in ("nogroup", "group"):
            if name == "group":
                dist.init_distributed(backend=backend, init_method=init_method,
                                      world_size=world, rank=rank)
                report["backend"] = torch.distributed.get_backend()
            for algo, argv in FAM_WORLD1.items():
                run = f"{algo}_{name}"
                harness.train([*argv, f"env.num_envs={NUM_ENVS}",
                               f"algo.train_every={FAM_WORLD1_STEPS}", "max_iters=2",
                               "log_interval=1", "save_interval=-1", f"run_dir={out / 'runs'}",
                               f"run_name={run}", f"seed={DP_SEED}"], device=dev)
                learners[run] = load_checkpoint(out / "runs" / run / "checkpoints")
        for algo in FAM_WORLD1:
            report[f"{algo}_bits_equal"] = _equal_trees(learners[f"{algo}_nogroup"],
                                                        learners[f"{algo}_group"])
            if not report[f"{algo}_bits_equal"]:
                raise AssertionError(f"world size 1, {algo}: the learner with a group differs "
                                     "from without")
    else:
        dist.init_distributed(backend=backend, init_method=init_method, world_size=world,
                              rank=rank)
    for case in FAM_CASES:
        saved = out / f"rollout_{case}.pt" if FAM_CASES[case][1] == "HideAndSeek" else None
        small, learner = _fam_iteration(dev, case, replay=saved if role == "fam2" else None,
                                        keep=saved if role == "fam1" else None)
        if role == "fam2":
            _dp_same_on_ranks(f"{role} rank {rank} {case} learner", learner)
        torch.save({"traj": small, "learner": learner}, out / f"{role}_{rank}_{case}.pt")
    report["launches"] = {k: v for k, v in wrappers.read().items() if v}
    (out / f"report_{role}_{rank}.json").write_text(json.dumps(report))
    dist.destroy()
    return 0


def phase_family_ranks() -> None:
    """Phase 15, part 1: the PPO family across ranks, in worker processes.
    World size 1 over NCCL: `harness.train` of ppo_rnn and transformer at
    4,096 arenas, 2 iterations, the learner's bits equal to the same run
    without a group.  Two ranks sharing the card over gloo: one iteration
    of each of FAM_CASES (phase 12's 1,024 x 32; MobileNet at 256 arenas),
    the ranks' learners bit-identical, the joined trajectory, the first
    gradients and the learner held against the one rank's iteration under
    phase 14's bounds.  No kernel launches on these paths."""
    log(f"[15] the PPO family across ranks: {', '.join(FAM_CASES)}")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        (one,) = _dp_launch("fam1", 1, "nccl", out, phase=15)
        for algo in FAM_WORLD1:
            log(f"  [1] world size 1, {algo} through harness.train ({NUM_ENVS} arenas x "
                f"{FAM_WORLD1_STEPS} steps, 2 iterations): with an NCCL group ({one['backend']}) "
                f"= without, bit for bit: {one[f'{algo}_bits_equal']}")
        two = _dp_launch("fam2", 2, "gloo", out, phase=15)
        failures = []
        for case in FAM_CASES:
            ref = torch.load(out / f"fam1_0_{case}.pt", weights_only=True)
            parts = [torch.load(out / f"fam2_{r}_{case}.pt", weights_only=True)
                     for r in range(2)]
            worst, flips = 0.0, 0.0
            discrete = FAM_CASES[case][1] == "HideAndSeek"
            for k in DP_TRAJ_KEYS:
                joined = torch.cat([p["traj"][k] for p in parts], dim=1)
                want = ref["traj"][k]
                if joined.shape != want.shape:
                    raise AssertionError(f"[15] {case}: trajectory field {k} of shape "
                                         f"{tuple(joined.shape)}, want {tuple(want.shape)}")
                off = (joined - want).abs() / max(1.0, float(want.abs().max()))
                first = float(off[0].max())
                share = float((off > DP_TRAJ_REL).float().mean())
                err = first if discrete else float(off.max())
                worst, flips = max(worst, err), max(flips, share)
                if err > DP_TRAJ_REL or (discrete and share > FAM_FLIP_SHARE):
                    failures.append(f"{case}: trajectory field {k} of the 2 ranks off the one "
                                    f"rank's by {err:.3e} of its scale ({share:.2%} of its "
                                    f"entries past {DP_TRAJ_REL})")
            got, want = parts[0]["learner"], ref["learner"]
            gerr = max(float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()),
                                                                   1e-30)
                       for k in want if k.startswith("grad"))
            perr = max(float((got[k] - want[k]).abs().max()) if got[k].numel() else 0.0
                       for k in want if k.startswith("ts/"))
            if gerr > DP_GRAD_REL or perr > DP_PARAM_ATOL:
                failures.append(f"{case}: the 2 ranks' first gradients are {gerr:.3e} of their "
                                f"scale off the one rank's (limit {DP_GRAD_REL}), the learner "
                                f"{perr:.3e} (limit {DP_PARAM_ATOL})")
            n_envs, steps = FAM_CASES[case][4:]
            held = (f"the first step within {worst:.3e} of each field's scale, {flips:.3%} of "
                    f"the entries past {DP_TRAJ_REL} (limit {FAM_FLIP_SHARE:.0%}), the update on "
                    f"the one rank's rollout" if discrete
                    else f"trajectory within {worst:.3e} of each field's scale")
            log(f"  [2] {case} ({n_envs} arenas x {steps} steps): ranks bit-identical; "
                f"{held} (limit {DP_TRAJ_REL}), "
                f"the first gradients within {gerr:.3e} (limit {DP_GRAD_REL}), the learner "
                f"within {perr:.3e} (limit {DP_PARAM_ATOL})")
        launched = {r["role"] + str(r["rank"]): r["launches"] for r in [one, *two] if r["launches"]}
        if launched:
            failures.append(f"the PPO family launched kernels: {launched}")
        if failures:
            raise AssertionError("[15] " + "; ".join(failures))
        log("  [3] every kernel count stayed 0 on these paths")


def _a5_hold(tag: str, card_val: torch.Tensor, cpu_val: torch.Tensor) -> float:
    """The card's first A5_CPU_ENVS arenas against the CPU's run, in metres."""
    err = float((card_val[:A5_CPU_ENVS].cpu() - cpu_val).abs().max())
    if not math.isfinite(err) or err > A5_TRAJ_ATOL:
        raise AssertionError(f"[15] {tag}: card vs CPU {err:.3e} m (limit {A5_TRAJ_ATOL})")
    return err


def phase_a5(dev) -> None:
    """Phase 15, part 2: the Lee, attitude, rate and DSL PID controllers,
    Dragon and the transport group at 4,096 arenas from seeded draws, each
    held against the port's CPU run of the first 64 arenas (A5_TRAJ_ATOL)
    and to the JAX tests' physical checks."""
    from mupe_tpu_torch import controllers as tc
    from mupe_tpu_torch.core import quat_rotate, quaternion_to_euler
    from mupe_tpu_torch.dynamics import dragon as dg
    from mupe_tpu_torch.dynamics import hover_state, make_params, step
    from mupe_tpu_torch.dynamics import transport as tr

    g = torch.Generator().manual_seed(A5_SEED)
    e = A5_ENVS
    spawn = torch.randn((e, 1, 3), generator=g) * 0.3 + torch.tensor([0.0, 0.0, 2.0])
    offset = torch.randn((e, 1, 3), generator=g) * 0.3
    level = torch.tensor([1.0, 0.0, 0.0, 0.0]).expand(e, 1, 4).contiguous()
    log(f"[15] controllers, Dragon and the transport group at {e} arenas, the first "
        f"{A5_CPU_ENVS} held against the CPU within {A5_TRAJ_ATOL} m")

    # Lee position control, 1,000 steps: the Firefly and the Hummingbird hover
    # at the spawn point from 0.05 m (sd) away; the Crazyflie at its exact
    # hover state (its Lee loop, the JAX package's gains, diverges from any
    # offset at dt 0.01 in both packages: a 1 mm offset falls 2 m in 1 s)
    for model, start in (("firefly", offset / 6.0), ("hummingbird", offset / 6.0),
                         ("crazyflie", torch.zeros_like(offset))):
        def lee(d, n, model=model, start=start):
            params, mixer = make_params(model, d), tc.make_mixer(model, d)
            s = hover_state(params, (spawn + start)[:n].to(d), level[:n].to(d))
            target = spawn[:n].to(d)
            for _ in range(1000):
                cmds = tc.lee_position_control(mixer, s.pos, s.quat, s.vel, s.angvel, target)
                s, _ = step(params, s, cmds, 0.01)
            return s.pos
        pos = lee(dev, e)
        err = float((pos - spawn.to(dev)).norm(dim=-1).max())
        hold = _a5_hold(f"Lee {model}", pos, lee("cpu", A5_CPU_ENVS))
        if not err < (0.1 if model != "crazyflie" else 1e-5):
            raise AssertionError(f"[15] Lee {model}: {err:.3e} m from its target after 10 s")
        log(f"  Lee position control, {model}, 1,000 steps from "
            f"{'0.05 m (sd) away' if model != 'crazyflie' else 'its hover state'}: within "
            f"{err:.2e} m of the target; card vs CPU {hold:.2e} m")

    # attitude control over the demo's setpoints, weight-matching thrust, from
    # 50 m, on the Hummingbird and the Firefly: the Crazyflie's loop at
    # dt 0.01 is chaotic (1e-6 rad/s moves it 14 m in 5 s; the demo's own
    # thrust, m^2 g, hides that on the ground)
    setpoints = [(0.0, 0.0), (0.15, 0.0), (0.0, 0.15), (-0.15, -0.15), (0.0, 0.0)]
    for model in ("hummingbird", "firefly"):
        def attitude(d, n, model=model):
            params, mixer = make_params(model, d), tc.make_mixer(model, d)
            s = hover_state(params, (spawn[:n] + torch.tensor([0.0, 0.0, 48.0])).to(d),
                            level[:n].to(d))
            thrust = params.gravity.expand(n, 1, 1)
            zero = torch.zeros((n, 1, 1), device=d)
            errs = []
            for roll, pitch in setpoints:
                r = torch.full((n, 1, 1), roll, device=d)
                p = torch.full((n, 1, 1), pitch, device=d)
                for _ in range(100):
                    cmds = tc.attitude_control(mixer, s.quat, s.angvel, thrust, zero, r, p)
                    s, _ = step(params, s, cmds, 0.01)
                rp = quaternion_to_euler(s.quat)[..., :2]
                errs.append(float((rp - torch.tensor([roll, pitch], device=d)).norm(dim=-1).max()))
            return s.pos, errs
        pos, errs = attitude(dev, e)
        hold = _a5_hold(f"attitude {model}", pos, attitude("cpu", A5_CPU_ENVS)[0])
        if not max(errs) < 0.01:
            raise AssertionError(f"[15] attitude {model}: roll/pitch errors {errs}")
        log(f"  attitude control, {model}, the demo's 5 setpoints x 100 steps: roll/pitch within "
            f"{max(errs):.2e} rad after each; card vs CPU {hold:.2e} m")

    # rate control: 45 deg/s of roll, 100 steps, from 50 m
    def rates(d, n):
        params, mixer = make_params("crazyflie", d), tc.make_mixer("crazyflie", d)
        s = hover_state(params, (spawn[:n] + torch.tensor([0.0, 0.0, 48.0])).to(d),
                        level[:n].to(d))
        target = torch.tensor([math.radians(45.0), 0.0, 0.0], device=d).expand(n, 1, 3)
        for _ in range(100):
            cmds = tc.rate_control(mixer, s.quat, s.angvel, target, params.gravity.expand(n, 1, 1))
            s, _ = step(params, s, cmds, 0.01)
        return s.body_rate, s.pos
    body, pos = rates(dev, e)
    hold = _a5_hold("rate", pos, rates("cpu", A5_CPU_ENVS)[1])
    rerr = float((body[..., 0] - math.radians(45.0)).abs().max()) / math.radians(45.0)
    if not rerr < 0.05:
        raise AssertionError(f"[15] rate control: roll rate {rerr:.3f} off its target")
    log(f"  rate control, 45 deg/s roll, 100 steps: within {rerr:.2e} of the target; card vs "
        f"CPU {hold:.2e} m")

    # DSL PID, 500 steps from 0.05 m (sd) off the spawn point.  Its gains (the
    # reference's PyBullet Crazyflie's motor model) do not hold this model's
    # Crazyflie (nor do the JAX package's: its test asks for finite commands):
    # the flight leaves, so every 100 steps each tick is held instead, the
    # card's commands against the CPU's from the card's state
    params = make_params("crazyflie", dev)
    target = spawn.to(dev)
    s = hover_state(params, (spawn + offset / 6.0).to(dev), level.to(dev))
    pid = tc.DSLPIDState.zeros((e, 1), device=dev)
    zero3, zero1 = torch.zeros((e, 1, 3), device=dev), torch.zeros((e, 1, 1), device=dev)
    n, worst = A5_CPU_ENVS, 0.0
    for i in range(500):
        cmds, new_pid = tc.dsl_pid_control(s.pos, s.quat, s.vel, target, zero3, zero1, pid, 0.01)
        if i % 100 == 0:
            ref, _ = tc.dsl_pid_control(
                s.pos[:n].cpu(), s.quat[:n].cpu(), s.vel[:n].cpu(), target[:n].cpu(),
                zero3[:n].cpu(), zero1[:n].cpu(),
                tc.DSLPIDState(*(x[:n].cpu() for x in (pid.integral_pos_error,
                                                       pid.integral_rpy_error, pid.last_rpy))),
                0.01)
            worst = max(worst, float((cmds[:n].cpu() - ref).abs().max())
                        / max(1.0, float(ref.abs().max())))
        pid = new_pid
        s, _ = step(params, s, cmds, 0.01)
    if not (worst <= 1e-5 and bool(torch.isfinite(s.pos).all())):
        raise AssertionError(f"[15] DSL PID: a tick card vs CPU {worst:.3e} of its scale")
    log(f"  DSL PID, 500 steps: finite; each 100th tick card vs CPU within {worst:.2e} of the "
        f"commands' scale")

    # Dragon: hover thrust, every joint driven about z, the gimbals out and back
    cfg = dg.DragonCfg()
    hover_cmd = 2.0 * (cfg.link_mass * 9.81 / (2.0 * cfg.kf)) - 1.0
    gimbal = 0.1 * (2.0 * torch.rand((e, 2 * cfg.num_links), generator=g) - 1.0)
    base = torch.zeros((e, cfg.action_dim))
    base[:, :cfg.num_rotors] = hover_cmd
    base[:, cfg.num_rotors + 2 * cfg.num_links + 1::2] = 0.6
    origin = spawn[:, 0] * torch.tensor([1.0, 1.0, 0.0]) + torch.tensor([0.0, 0.0, 2.0])

    def dragon(d, n):
        actions = []
        for sign in (1.0, -1.0, 0.0):
            a = base[:n].clone()
            a[:, cfg.num_rotors:cfg.num_rotors + 2 * cfg.num_links] = sign * gimbal[:n]
            actions.append(a.to(d))
        s = dg.dragon_init(cfg, origin[:n].to(d))
        for i in range(300):
            s = dg.dragon_step(cfg, s, actions[i // 100], 0.01)
        return s
    st = dragon(dev, e)
    hold = _a5_hold("Dragon", st.pos, dragon("cpu", A5_CPU_ENVS).pos)
    gaps = (st.pos[:, 1:] - st.pos[:, :-1]).norm(dim=-1)
    gap_err = float((gaps - cfg.link_spacing).abs().max())
    end_to_end = float((st.pos[:, -1] - st.pos[:, 0]).norm(dim=-1).max())
    drop = float((st.pos[..., 2] - origin[:, None, 2].to(dev)).abs().max())
    sv = dg.dragon_state_vector(cfg, st)
    if not (gap_err < 0.1 and end_to_end < cfg.link_spacing * (cfg.num_links - 1) - 0.05
            and drop < 0.5 and bool(torch.isfinite(sv).all()) and sv.shape[-1] == cfg.state_dim):
        raise AssertionError(f"[15] Dragon: gaps off by {gap_err:.3f}, end to end "
                             f"{end_to_end:.3f}, altitude {drop:.3f}")
    log(f"  Dragon, 300 steps (4 substeps each): the chain holds (gaps within {gap_err:.3f} m of "
        f"{cfg.link_spacing}), bent (end to end at most {end_to_end:.3f} m), altitude within "
        f"{drop:.3f} m; card vs CPU {hold:.2e} m")

    # transport: the demo's 900-tick ramp, 3 m across and 0.7 m up
    tcfg = tr.TransportCfg()
    group = spawn[:, 0] * torch.tensor([3.0, 3.0, 0.0]) + torch.tensor([0.0, 0.0, 1.5])

    def transport(d, n):
        params, mixer = tr.make_transport_params(tcfg, d), tc.make_mixer(tcfg.drone_model, d)
        s = tr.transport_init(tcfg, params, group[:n].to(d))
        start = s.drones.pos
        goal = start + torch.tensor([3.0, 0.0, 0.7], device=d)
        for k in range(900):
            frac = min(k / 600.0, 1.0)
            cmds = tc.lee_position_control(mixer, s.drones.pos, s.drones.quat, s.drones.vel,
                                           s.drones.angvel, start + frac * (goal - start))
            s = tr.transport_step(tcfg, params, s, cmds, dt=0.016)
        return s, goal
    st, goal = transport(dev, e)
    cpu_st, _ = transport("cpu", A5_CPU_ENVS)
    hold = max(_a5_hold("transport drones", st.drones.pos, cpu_st.drones.pos),
               _a5_hold("transport payload", st.payload_pos, cpu_st.payload_pos))
    anchors = st.payload_pos[:, None] + quat_rotate(st.payload_quat[:, None],
                                                    tcfg.anchor_body.to(dev)[None])
    rods = float(((st.drones.pos - anchors).norm(dim=-1) - tcfg.bar_length).abs().max())
    below = bool((st.drones.pos[..., 2].min(dim=-1).values > st.payload_pos[:, 2]).all())
    err = float((st.drones.pos - goal).norm(dim=-1).mean())
    if not (rods < 0.1 and below and bool(torch.isfinite(st.drones.pos).all())):
        raise AssertionError(f"[15] transport: rods off by {rods:.3f}, payload below: {below}")
    log(f"  transport, the demo's 900 ticks (4 substeps each): rods within {rods:.3f} m of "
        f"{tcfg.bar_length}, the payload below the drones, mean drone target error {err:.3f} m; "
        f"card vs CPU {hold:.2e} m")


def phase_examples() -> None:
    """Phase 15, part 3: every `mupe_tpu_torch.examples` module run as
    `python -m` would run it, on the card (its default), in one child
    process that must exit 0."""
    from mupe_tpu_torch.examples import EXAMPLES

    code = ("import runpy, sys\n"
            f"for name in {list(EXAMPLES)!r}:\n"
            "    print('== ' + name, flush=True)\n"
            "    sys.argv = [name]\n"
            "    runpy.run_module('mupe_tpu_torch.examples.' + name, run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=EXAMPLES_TIMEOUT, cwd=str(Path(__file__).resolve().parent))
    if proc.returncode != 0:
        raise AssertionError(f"[15] the examples exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    blocks, name = {}, None
    for line in proc.stdout.splitlines():
        if line.startswith("== ") and line[3:] in EXAMPLES:
            name = line[3:]
            blocks[name] = []
        elif name is not None and line.strip():
            blocks[name].append(line)
    if sorted(blocks) != sorted(EXAMPLES) or not all(blocks.values()):
        raise AssertionError(f"[15] the examples printed {sorted(blocks)}")
    for name in EXAMPLES:
        log(f"  python -m mupe_tpu_torch.examples.{name}: exit 0; last line: {blocks[name][-1]}")


def phase_15(dev, card: str) -> None:
    t0 = time.perf_counter()
    phase_family_ranks()
    phase_a5(dev)
    phase_examples()
    log(f"[15] phase 15 took {time.perf_counter() - t0:.1f} s on {card}")

# phase 16: evaluation videos (`utils/render.py`, `video` in evaluate and train)
VIDEO_ARENA = 1234               # the arena phase 16's full-width evaluation draws
VIDEO_CPU_ENVS, VIDEO_CPU_STEPS = 16, 32
VIDEO_RANK_ENVS, VIDEO_RANK_ARENA = 1024, 700   # 512 arenas a rank: the arena on rank 1
VIDEO_RANK_EPISODE = 16
DEMO_TIMEOUT = 180


def gif_decode(data: bytes):
    """A GIF89a's colour table and its frames composited as palette
    indices [H, W] (disposal "do not dispose"), by a decoder of its own:
    the card's machine has no PIL."""
    w, h, packed = data[6] | data[7] << 8, data[8] | data[9] << 8, data[10]
    size = 2 << (packed & 7)
    table = torch.frombuffer(bytearray(data[13:13 + 3 * size]), dtype=torch.uint8).reshape(size, 3)
    pos, canvas, frames = 13 + 3 * size, bytearray(w * h), []
    while data[pos] != 0x3B:
        kind = data[pos]
        if kind == 0x21:
            pos += 2
        else:
            x, y, fw, fh = (data[pos + 1 + 2 * i] | data[pos + 2 + 2 * i] << 8 for i in range(4))
            min_size, pos = data[pos + 10], pos + 11
        chunks = []
        while data[pos]:
            chunks.append(data[pos + 1:pos + 1 + data[pos]])
            pos += 1 + data[pos]
        pos += 1
        if kind == 0x2C:
            pix = _lzw_decode(b"".join(chunks), min_size)
            if len(pix) != fw * fh:
                raise AssertionError(f"a GIF frame of {len(pix)} pixels in a {fw} x {fh} box")
            for r in range(fh):
                canvas[(y + r) * w + x:(y + r) * w + x + fw] = pix[r * fw:(r + 1) * fw]
            frames.append(torch.frombuffer(bytearray(canvas), dtype=torch.uint8).reshape(h, w))
    return table, frames


def _lzw_decode(data: bytes, min_size: int) -> bytes:
    clear, end = 1 << min_size, (1 << min_size) + 1
    out, table, width, prev = bytearray(), [], min_size + 1, None
    acc = nbits = pos = 0
    while True:
        while nbits < width:
            acc |= data[pos] << nbits
            pos, nbits = pos + 1, nbits + 8
        code, acc, nbits = acc & ((1 << width) - 1), acc >> width, nbits - width
        if code == clear:
            table = [bytes([i]) for i in range(clear)] + [b"", b""]
            width, prev = min_size + 1, None
            continue
        if code == end:
            return bytes(out)
        if prev is None:
            entry = table[code]
        else:
            entry = table[code] if code < len(table) else prev + prev[:1]
            if len(table) < 4096:
                table.append(prev + entry[:1])
                if len(table) == 1 << width and width < 12:
                    width += 1
        out += entry
        prev = entry


def _video_frames(info: dict, every: int = 2) -> list:
    """`render_trajectory`'s frames of a collected arena as palette
    indices (`render_trajectory` is the palette's colours of these)."""
    from mupe_tpu_torch.utils import render

    return list(render.index_trajectory(
        info["drone_pos"][:, 0], info["target_pos"][:, 0, 0], info["cylinders"][:, 0],
        captured=info["capture"][:, 0, 0] if "capture" in info else None,
        predicted=info["tp_pred"][:, 0] if "tp_pred" in info else None, every=every))


def _hold_gif(tag: str, data: bytes, want: list) -> None:
    """The GIF decodes to the frames `want` (palette indices) over the
    renderer's palette."""
    from mupe_tpu_torch.utils import render

    table, frames = gif_decode(data)
    pal = torch.from_numpy(render.PALETTE)
    if not torch.equal(table[:len(pal)], pal):
        raise AssertionError(f"[16] {tag}: the GIF's colour table is not the renderer's palette")
    bad = sum(not torch.equal(f, torch.from_numpy(w)) for f, w in zip(frames, want))
    if len(frames) != len(want) or bad:
        raise AssertionError(f"[16] {tag}: {len(frames)} GIF frames for {len(want)}, {bad} differ")


class _Recorder:
    """Wraps the harness's `episode_video` for a run: the info each video
    drew and its path."""

    def __init__(self):
        from mupe_tpu_torch import harness

        self.harness, self.infos, self.paths = harness, [], []
        self.real = harness.episode_video

    def __enter__(self):
        def video(info, cfg, path, *args, **kwargs):
            self.infos.append(info)
            self.paths.append(path)
            return self.real(info, cfg, path, *args, **kwargs)

        self.harness.episode_video = video
        return self

    def __exit__(self, *exc):
        self.harness.episode_video = self.real


def _video_full_width(dev, first: dict, tmp: Path) -> None:
    """Phase 10's evaluation again (its argv, 4,096 arenas x 800 steps on
    the wall scenario) with `video` of arena VIDEO_ARENA: the stats equal
    phase 10's bit for bit, the launches too, and the GIF holds the 400
    frames the renderer draws from the collected arrays."""
    from mupe_tpu_torch import harness
    from mupe_tpu_torch.utils import render

    path = tmp / "ev.gif"
    argv = first["argv"] + [f"video={path}", f"video_env_index={VIDEO_ARENA}"]
    log(f"[16] evaluation with a video: phase 10's harness.evaluate (wall, use_eval, {NUM_ENVS} "
        f"x {EVAL_EPISODE}) + video=ev.gif video_env_index={VIDEO_ARENA}")
    wrappers = Launches("encoder_pair_forward", "tp_forward")
    with _Recorder() as rec:
        result = harness.evaluate(argv, device=dev)
    launches = wrappers.read()
    if result != first["result"]:
        diff = {k: (v, first["result"].get(k)) for k, v in result.items()
                if v != first["result"].get(k)}
        raise AssertionError(f"[16] the evaluation with a video differs from phase 10's: {diff}")
    if launches != first["launches"]:
        raise AssertionError(f"[16] launches {launches} with a video, {first['launches']} "
                             f"without: rendering launched a kernel")
    (info,) = rec.infos
    frames = _video_frames(info)
    data = path.read_bytes()
    if render.encode_gif(frames) != data:
        raise AssertionError("[16] encoding the same frames again gives another file")
    _hold_gif("the full-width evaluation", data, frames)
    n = len(frames)
    if n != EVAL_EPISODE // 2:
        raise AssertionError(f"[16] {n} frames for an {EVAL_EPISODE}-step episode")
    log(f"  stats equal phase 10's bit for bit ({len(result)} values); launches {launches}, "
        f"phase 10's {first['launches']}: rendering launched no kernel")
    log(f"  the GIF decodes to {n} frames equal to render_trajectory of the collected arrays "
        f"({len(data)} bytes, {len(data) / n:.1f} a frame)")


def _hold_frame_dicts(tag: str, got: dict, want: dict, step: float, atol: float = 1e-2) -> str:
    """One arena's frames from two runs of the same free-running episode:
    the pursuers and the evader's x, z within `atol`, the evader's y within
    two of its steps (it starts on the wall scene's mirror axis, where the
    sign of a rounding-level force component picks its y step), the
    cylinders and captures equal, the TP prediction within `atol` at the
    first step and finite."""
    import numpy as np

    if set(got) != set(want) or any(got[k].shape != want[k].shape for k in got):
        raise AssertionError(f"[16] {tag}: keys or shapes differ")
    xz = [0, 2]
    errs = {"drone_pos": abs(got["drone_pos"] - want["drone_pos"]).max(),
            "target_xz": abs(got["target_pos"][..., xz] - want["target_pos"][..., xz]).max(),
            "tp_pred_0": abs(got["tp_pred"][0] - want["tp_pred"][0]).max()}
    y = abs(got["target_pos"][..., 1] - want["target_pos"][..., 1]).max()
    same = all((got[k] == want[k]).all() for k in ("cylinders", "capture"))
    finite = all(np.isfinite(v).all() for v in got.values())
    if max(errs.values()) > atol or y > 2 * step or not same or not finite:
        raise AssertionError(f"[16] {tag}: {errs}, target y {y:.3e} (limit {2 * step:.3e}), "
                             f"cylinders and captures equal: {same}")
    return (", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (limit {atol}); target y "
            f"{y:.3e} (limit {2 * step:.3f}); cylinders and captures equal")


def _video_cpu(dev, first: dict, tmp: Path) -> None:
    """The card's frame dict against the CPU's: phase 10's checkpoint on
    the wall scenario at VIDEO_CPU_ENVS arenas x VIDEO_CPU_STEPS steps."""
    from mupe_tpu_torch import harness

    argv = [a for a in first["argv"] if not a.startswith(("env.num_envs=", "env.max_episode"))]
    argv += [f"env.num_envs={VIDEO_CPU_ENVS}", f"env.max_episode_length={VIDEO_CPU_STEPS}",
             f"video_env_index={VIDEO_CPU_ENVS - 3}"]
    infos = {}
    for d in ("cpu", dev):
        with _Recorder() as rec:
            harness.evaluate(argv + [f"video={tmp}/cpu_{d}.gif"], device=d)
        infos[d] = rec.infos[0]
    cfg = harness.ENV_REGISTRY["HideAndSeek"].cfg_cls()
    held = _hold_frame_dicts("card vs CPU", infos[dev], infos["cpu"],
                             cfg.v_prey * cfg.v_drone * cfg.dt)
    log(f"[16] the card's frame dict against the CPU's, {VIDEO_CPU_ENVS} arenas x "
        f"{VIDEO_CPU_STEPS} steps, arena {VIDEO_CPU_ENVS - 3}: {held}")


def _video_train(dev, tmp: Path) -> None:
    """`harness.train` at phase 10's cut, 2 iterations, eval_interval=1
    video=1: eval_1.gif and eval_2.gif in the run directory, each the
    renderer's frames of its collected arena."""
    from mupe_tpu_torch import harness

    argv = [f"env.num_envs={NUM_ENVS}", *RECIPE, f"env.max_episode_length={AEG_EPISODE}",
            "env.r_min=0.0", "max_iters=2", "eval_interval=1", "video=1",
            f"video_env_index={VIDEO_ARENA}", "log_interval=1", "save_interval=-1",
            f"run_dir={tmp}", "run_name=train", "seed=10"]
    with _Recorder() as rec:
        metrics = harness.train(argv, default_task="HideAndSeek_envgen", device=dev)
    names = sorted(p.name for p in (tmp / "train").glob("*.gif"))
    if names != ["eval_1.gif", "eval_2.gif"] or not math.isfinite(metrics["eval/return"]):
        raise AssertionError(f"[16] train with a video wrote {names}")
    for info, gif in zip(rec.infos, rec.paths):
        _hold_gif(f"train's {Path(gif).name}", Path(gif).read_bytes(), _video_frames(info))
    log(f"[16] harness.train at phase 10's cut, 2 iterations, eval_interval=1 video=1: {names}, "
        f"{AEG_EPISODE // 2} frames each, equal to the renderer's")


def _video_rank_argv(run_dir: Path, name: str) -> list:
    """One iteration at learning rate 0 (the learner stays the one-rank
    run's) with an evaluation video of arena VIDEO_RANK_ARENA."""
    return [f"env.num_envs={VIDEO_RANK_ENVS}", f"env.max_episode_length={VIDEO_RANK_EPISODE}",
            f"algo.train_every={VIDEO_RANK_EPISODE}", "max_iters=1", "eval_interval=1",
            "video=1", f"video_env_index={VIDEO_RANK_ARENA}", "algo.actor_lr=0",
            "algo.critic_lr=0", "algo.tp_lr=0", "log_interval=1", "save_interval=-1",
            f"run_dir={run_dir}", f"run_name={name}", f"seed={DP_SEED}"]


def _video_worker(rank: int, world: int, backend: str, init_method: str, out: Path) -> int:
    """A rank of phase 16's two (`--dp-worker video ...`): `harness.train`
    (`_video_rank_argv`) with a gloo group; reports the GIFs it wrote."""
    from mupe_tpu_torch import harness
    from mupe_tpu_torch.parallel import dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_distributed(backend=backend, init_method=init_method, world_size=world, rank=rank)
    with _Recorder() as rec:
        harness.train(_video_rank_argv(out / "runs", "ranks"), device=dev)
    (out / f"report_video_{rank}.json").write_text(json.dumps({"written": rec.paths}))
    dist.destroy()
    return 0


def _video_ranks(dev, tmp: Path) -> None:
    """Two ranks sharing the card over gloo, arena VIDEO_RANK_ARENA on rank
    1: rank 0 writes eval_1.gif, rank 1 nothing, and its frames equal the
    one-rank run's (this process, no group)."""
    from mupe_tpu_torch import harness

    ranks = _dp_launch("video", 2, "gloo", tmp, phase=16)
    written = [r["written"] for r in ranks]
    if [len(w) for w in written] != [1, 0]:
        raise AssertionError(f"[16] the 2 ranks wrote {written}")
    harness.train(_video_rank_argv(tmp / "runs", "one"), device=dev)
    two = gif_decode((tmp / "runs" / "ranks" / "eval_1.gif").read_bytes())[1]
    one = gif_decode((tmp / "runs" / "one" / "eval_1.gif").read_bytes())[1]
    bad = sum(not torch.equal(a, b) for a, b in zip(two, one))
    if len(two) != len(one) or len(one) != VIDEO_RANK_EPISODE // 2 or bad:
        raise AssertionError(f"[16] 2 ranks' GIF: {len(two)} frames, the one rank's {len(one)}, "
                             f"{bad} differ")
    log(f"[16] 2 ranks sharing the card over gloo, {VIDEO_RANK_ENVS} arenas, arena "
        f"{VIDEO_RANK_ARENA} on rank 1: rank 0 wrote {Path(written[0][0]).name}, rank 1 none; its "
        f"{len(two)} frames equal the one-rank run's")


def _video_demo(tmp: Path) -> None:
    """`python -m mupe_tpu_torch.examples.demo_hideandseek_rollout --gif`
    in a child process (its working directory `tmp`): exit 0, `gif:`
    printed, 100 frames."""
    repo = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-m", "mupe_tpu_torch.examples.demo_hideandseek_rollout",
                           "--gif"], capture_output=True, text=True, timeout=DEMO_TIMEOUT,
                          cwd=str(tmp), env=env)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines or not lines[-1].startswith("gif: "):
        raise AssertionError(f"[16] the demo exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    _, frames = gif_decode((tmp / lines[-1][5:]).read_bytes())
    if len(frames) != 100:
        raise AssertionError(f"[16] the demo's GIF holds {len(frames)} frames")
    stats = "; ".join(" ".join(ln.split()) for ln in lines[1:-1])
    log(f"[16] python -m mupe_tpu_torch.examples.demo_hideandseek_rollout --gif: exit 0, "
        f"{lines[-1]} ({len(frames)} frames); {stats}")


def phase_video(dev, card: str, first: dict) -> None:
    """Phase 16: evaluation videos.  Phase 10's evaluation again with a
    video; the card's frame dict against the CPU's; `train` with
    eval_interval=1 video=1; two ranks with the arena on rank 1; the demo
    with --gif."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _video_full_width(dev, first, tmp)
        _video_cpu(dev, first, tmp)
        _video_train(dev, tmp)
        _video_ranks(dev, tmp)
        _video_demo(tmp)
    log(f"[16] phase 16 took {time.perf_counter() - t0:.1f} s on {card}")


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
    phase_slice(dev)
    launches = phase_train(dev)
    launches["farthest_point_sampling"] = phase_aeg(dev)["farthest_point_sampling"]
    launches.update(phase_inkernel(dev))
    phase_config_train(dev, 7, "wide-configuration", WIDE_ENV, (None, "agrad"))
    phase_config_train(dev, 8, "16-token", TOK16_ENV, (None, "fwdloss", "agrad"))
    phase_config_train(dev, 9, "past-the-tile-limits", LIMIT_ENV, (None, "fwdloss", "agrad"))
    # phase 10's run directory: phase 16 evaluates its checkpoint again
    eval_dir = tempfile.TemporaryDirectory()
    first_eval = phase_eval(dev, eval_dir.name)
    eval_launches = first_eval["launches"]
    phase_hover(dev)
    t12 = time.perf_counter()
    option_kernels = phase_option_kernels(dev)
    per_iter = phase_options(dev)
    phase_family(dev)
    log(f"[12] phase 12 took {time.perf_counter() - t12:.1f} s on {card}")
    t13 = time.perf_counter()
    phase_vision_rma(dev)
    log(f"[13] phase 13 took {time.perf_counter() - t13:.1f} s on {card}")
    phase_parallel(card)
    phase_15(dev, card)
    with eval_dir:
        phase_video(dev, card, first_eval)
    for name, extra in option_kernels.items():
        kernels[name].update(extra, share_actor_false_launches_per_iteration=per_iter[name])
    launches["encoder_backward:stage_b"] = launches["weight_grads"]
    launches["tp_backward:stage_b"] = launches["tp_weight_grads"]
    summary = {"kernels": [
        dict(name=name, launches=launches[name], **info,
             **({"stage_b_launches": launches[f"{name}:stage_b"]}
                if f"{name}:stage_b" in launches else {}),
             **({"eval_launches": eval_launches[name]} if name in eval_launches else {}))
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
    if len(sys.argv) > 1 and sys.argv[1] == DP_WORKER_FLAG:
        sys.exit(dp_worker(sys.argv[2:]))
    sys.exit(main())
