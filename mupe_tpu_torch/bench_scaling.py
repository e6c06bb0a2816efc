"""Scaling of the training iteration over ranks (counterpart of
scripts/bench_scaling.py): bench.py's configuration (HideAndSeek, 3
pursuers, random cylinders, the TP net on; MAPPO) trained by R ranks that
each hold num_envs / R arenas.

    torchrun --nproc_per_node=N -m mupe_tpu_torch.bench_scaling \\
        [--num-envs 4096] [--train-every 64] [--iters 3] [--base-rate R1]

Rank 0 prints one JSON row for the world size it ran at: the aggregate
env-steps/s over `--iters` timed iterations after 2 warm-up ones, and the
efficiency, rate / (R x the world-size-1 rate): 1 at world size 1, else
against `--base-rate` (a world-size-1 run's value) when it is given.
Without torchrun it runs one rank.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .harness import build
from .learning import init_carry, make_train_iter
from .parallel import dist

WARMUP = 2  # iterations before the timed ones (scripts/bench_scaling.py's)


def _sync(device: torch.device) -> None:
    """Every rank has finished its queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dist.all_reduce_sum(torch.zeros(1, device=device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--train-every", type=int, default=64)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--base-rate", type=float, default=None,
                    help="the world-size-1 env-steps/s the efficiency is measured against")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dist.init_distributed()
    device = dist.local_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    env, policy, _, _ = build("HideAndSeek", {"num_envs": args.num_envs,
                                              "max_episode_length": 800},
                              {"train_every": args.train_every, "use_tp_net": True},
                              device=device)
    carry = init_carry(env, policy, torch.Generator(device=device).manual_seed(0))
    train_iter = make_train_iter(env, policy)
    for _ in range(WARMUP):
        carry, metrics, _ = train_iter(carry)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        carry, metrics, _ = train_iter(carry)
    _sync(device)
    seconds = time.perf_counter() - t0
    world = dist.world_size()
    rate = args.num_envs * args.train_every * args.iters / seconds
    row = {"metric": "scaling_env_steps_per_s", "world_size": world, "value": rate,
           "unit": "env-steps/s", "num_envs": args.num_envs, "train_every": args.train_every,
           "iters": args.iters, "policy_loss": float(metrics["policy_loss"])}
    if world == 1:
        row["efficiency"] = 1.0
    elif args.base_rate:
        row["efficiency"] = rate / (args.base_rate * world)
    if dist.rank() == 0:
        print(json.dumps(row), flush=True)
    dist.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
