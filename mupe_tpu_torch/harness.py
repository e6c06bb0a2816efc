"""Experiment harness: build env + policy from config, run the training loop,
evaluate a policy (counterpart of mupe_tpu/harness.py).

`train` publishes the JAX package's headline metrics under the same names
(`rollout_fps`, `rollout_fps_med`, `rollout_fps_avg`, `env_frames`, the
update's metrics, `stats/<episode stat>` and, with `eval_interval`,
`eval/<episode stat>`), writes them to a CSV (and wandb, if enabled), and
saves the learner state and the full carry; `guard_nan` skips iterations
whose loss went non-finite and `profile_dir` traces iterations 1-3.
`evaluate` runs one greedy episode, by default on the fixed evaluation
scenario (HideAndSeek's: it forces `use_eval`, which only HideAndSeek's
configurations have, as in the JAX package).  Tasks: HideAndSeek and its
AEG and sim-free variants, and Hover on flat observations.

Not ported yet (each raises NotImplementedError): algorithms other than
MAPPO (`train_rma` among them), so Hover's dict observations (domain
randomization, the observation history: ppo_adapt's inputs) and its depth
camera, and evaluation videos (`video`: `utils/render.py` draws with
matplotlib, which the port does not depend on).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .envs import ENV_REGISTRY
from .learning import MAPPOCfg, MAPPOPolicy, init_carry, make_train_iter
from .utils.checkpoint import load_checkpoint, save_checkpoint
from .utils.config import RunCfg, apply_overrides, parse_cli
from .utils.debug import guard_train_iter, profile_trace
from .utils.logging import RunLogger, config_dict

_NO_VIDEO = ("video (evaluation GIFs) is not ported: utils/render.py draws with matplotlib, "
             "which the port does not depend on")


def build(
    task: str,
    env_overrides: Optional[Dict[str, Any]] = None,
    algo_overrides: Optional[Dict[str, Any]] = None,
    algo: str = "mappo",
    device: torch.device | str = "cuda",
):
    """(env, policy, env_cfg, algo_cfg) for a registered task (the env class
    and its `cfg_cls`) and MAPPO.  For an env that provides the TP net's
    input, the policy's TP-net settings follow the env's first, so `algo.*`
    overrides still win; the observation is a dict for such an env or where
    the env's configuration says so (mupe_tpu/learning/registry.py `_mk_cfg`,
    `_obs_is_dict`)."""
    if algo.lower() != "mappo":
        raise NotImplementedError(f"algo {algo!r} is not ported yet (MAPPO only)")
    if task not in ENV_REGISTRY:
        raise NotImplementedError(f"task {task!r} is not ported yet; have {sorted(ENV_REGISTRY)}")
    env_cls = ENV_REGISTRY[task]
    env_cfg = apply_overrides(env_cls.cfg_cls(), env_overrides or {})
    env = env_cls(env_cfg, device=device)
    provides_tp = getattr(env, "provides_tp", False)
    algo_cfg = MAPPOCfg()
    if provides_tp:
        algo_cfg = dataclasses.replace(
            algo_cfg, use_tp_net=env_cfg.use_tp_net,
            future_prediction_step=env_cfg.future_prediction_step,
            window_step=env_cfg.window_step)
    algo_cfg = apply_overrides(algo_cfg, algo_overrides or {})
    policy = MAPPOPolicy(
        algo_cfg, n_agents=env.num_agents, action_dim=env.action_dim,
        obs_is_dict=provides_tp or bool(getattr(env_cfg, "obs_is_dict", False)),
        tp_input_dim=getattr(env_cfg, "tp_input_dim", None) if provides_tp else None,
        device=device, tp_history_step=getattr(env_cfg, "history_step", 10))
    return env, policy, env_cfg, algo_cfg


def train(
    argv: Sequence[str],
    default_task: str = "HideAndSeek",
    deploy_stage: bool = False,
    device: torch.device | str = "cuda",
) -> Dict[str, float]:
    """The training loop (mupe_tpu/harness.py:75-241): `max_iters` or
    `total_frames`, a log row every `log_interval` iterations, a checkpoint
    every `save_interval` and at the end, `model_dir` warm start and
    `resume_dir` exact resume; an evaluation episode every `eval_interval`
    iterations (`_make_eval_prog`), the NaN guard (`guard_nan`) and a
    profiler trace of iterations 1-3 into `profile_dir`.  `deploy_stage=True`
    threads the iteration into the env's `update_epoch`, so the smoothness
    reward ramps.  Returns the last log row's values (with the last
    evaluation's) and `total_time_s`."""
    sections, top = parse_cli(argv)
    run_cfg = apply_overrides(RunCfg(task=default_task), top)
    if run_cfg.video:
        raise NotImplementedError(f"train: {_NO_VIDEO}")
    env, policy, env_cfg, algo_cfg = build(
        run_cfg.task, sections.get("env"), sections.get("algo"), run_cfg.algo, device)
    if deploy_stage:
        env_cfg = dataclasses.replace(env_cfg, use_deployment=True)
        env = type(env)(env_cfg, device=device)

    run_name = run_cfg.run_name or time.strftime("%Y%m%d-%H%M%S")
    ckpt_dir = Path(run_cfg.run_dir) / run_name / "checkpoints"
    logger = RunLogger(
        run_cfg.run_dir, run_name, wandb_mode=run_cfg.wandb_mode,
        wandb_project=run_cfg.wandb_project, wandb_entity=run_cfg.wandb_entity,
        config=config_dict(run_cfg, env_cfg, algo_cfg),
    )
    gen = torch.Generator(device=device).manual_seed(run_cfg.seed)
    carry = init_carry(env, policy, gen)
    if run_cfg.model_dir:
        # warm start: the learner state only
        carry.ts = load_checkpoint(run_cfg.model_dir, target=carry.ts)
    if run_cfg.resume_dir:
        # exact resume: the full carry (learner, env state with the AEG
        # buffer and curriculum scalars, last observation, generator)
        carry = load_checkpoint(run_cfg.resume_dir, target=carry)
    train_iter = make_train_iter(env, policy)
    if run_cfg.guard_nan:
        # skip updates whose loss went non-finite instead of corrupting the
        # run: a copy of the carry and one scalar host sync an iteration
        train_iter = guard_train_iter(train_iter)
    eval_prog = (_make_eval_prog(env, policy, run_cfg.seed) if run_cfg.eval_interval > 0
                 else None)

    frames_per_iter = env.num_envs * algo_cfg.train_every
    if run_cfg.max_iters > 0:
        num_iters = run_cfg.max_iters
    else:
        num_iters = max(1, run_cfg.total_frames // frames_per_iter)

    env_frames = 0
    last_metrics: Dict[str, float] = {}
    t_start = time.time()
    t_block = t_start
    # the median over the last 15 log points is stable under timing noise
    fps_window: deque = deque(maxlen=15)
    prof = contextlib.ExitStack()
    for i in range(num_iters):
        if run_cfg.profile_dir:
            if i == 1:
                prof.enter_context(profile_trace(run_cfg.profile_dir))
            elif i == 4:
                prof.close()
        if deploy_stage:
            carry.env_state.update_epoch = torch.tensor(
                float(i), device=carry.env_state.update_epoch.device)
        carry, metrics, ep_stats = train_iter(carry)
        env_frames += frames_per_iter
        if (i + 1) % run_cfg.log_interval == 0 or i == num_iters - 1:
            row = {
                **{k: float(v) for k, v in metrics.items()},
                **{f"stats/{k}": float(v) for k, v in ep_stats.items()},
            }  # float() waits for the device
            now = time.time()
            fps = frames_per_iter * run_cfg.log_interval / max(now - t_block, 1e-9)
            t_block = now
            fps_window.append(fps)
            row.update(rollout_fps=fps, rollout_fps_med=float(np.median(fps_window)),
                       rollout_fps_avg=env_frames / max(now - t_start, 1e-9),
                       env_frames=env_frames)
            logger.log(row, step=env_frames)
            last_metrics = {k: float(v) for k, v in row.items()}
        if eval_prog is not None and (i + 1) % run_cfg.eval_interval == 0:
            ev_row = {f"eval/{k}": float(v) for k, v in eval_prog(carry.ts, i).items()}
            logger.log(ev_row, step=env_frames)
            last_metrics.update(ev_row)
        if run_cfg.save_interval > 0 and (i + 1) % run_cfg.save_interval == 0:
            save_checkpoint(ckpt_dir, i + 1, carry.ts)
            save_checkpoint(ckpt_dir / "full", i + 1, carry)
    prof.close()
    save_checkpoint(ckpt_dir, num_iters, carry.ts)
    save_checkpoint(ckpt_dir / "full", num_iters, carry)
    logger.close()
    last_metrics["total_time_s"] = time.time() - t_start
    return last_metrics


@torch.no_grad()
def _greedy_episode(env, policy: MAPPOPolicy, ts, env_state, obs, gen: torch.Generator):
    """`max_episode_length` greedy steps (`deterministic=True`) from
    `env_state` and its observation `obs`.  Returns (stat keys, the
    done-masked sum of each stat [K], the number of finished episodes, and
    each step's first_capture_step where an episode finished, NaN elsewhere
    [T, E], or None for an env without that stat).  The sums accumulate step
    by step: no trajectory is kept."""
    provides_tp = getattr(env, "provides_tp", False)
    step_args = (ts.tp_net if policy.cfg.use_tp_net else None,) if provides_tp else ()
    keys, sums, n_done, capture = None, 0.0, 0.0, []
    for _ in range(env.cfg.max_episode_length):
        action, _, _ = policy.act(ts, obs, deterministic=True)
        env_state, tr = env.step(env_state, action, gen, *step_args)
        done = tr.done.float()                                      # [E, 1]
        keys = keys or list(tr.stats)  # one order for every step
        stats = torch.cat([tr.stats[k] for k in keys], dim=1)       # [E, K]
        sums = sums + torch.sum(stats * done, dim=0)
        n_done = n_done + torch.sum(done)
        if "first_capture_step" in tr.stats:
            capture.append(torch.where(tr.done, tr.stats["first_capture_step"], math.nan)[:, 0])
        obs = tr.obs
    return keys, sums, n_done, torch.stack(capture) if capture else None


def _make_eval_prog(env, policy: MAPPOPolicy, seed: int):
    """One-episode greedy evaluation (mupe_tpu/harness.py:244-322):
    `prog(ts, i)` resets the training env's configuration afresh from a
    generator of its own, seeded from `seed + 7919` and the iteration `i`
    (JAX: `fold_in(PRNGKey(seed + 7919), i)`), acts greedily for
    `max_episode_length` steps and returns the done-masked mean of every
    stat (NaN where no episode finished) and `episode_count`.  It neither
    reads nor advances the training carry or its generator."""

    def prog(ts, i: int) -> Dict[str, torch.Tensor]:
        gen = torch.Generator(device=env.device).manual_seed((seed + 7919) * 2**32 + i)
        env_state = env.reset(gen)
        if getattr(env, "provides_tp", False):
            obs, _ = env.observe_full(env_state, ts.tp_net)
        else:
            obs = env.observe(env_state)
        keys, sums, n_done, _ = _greedy_episode(env, policy, ts, env_state, obs, gen)
        means = torch.where(n_done > 0, sums / torch.clamp(n_done, min=1.0), math.nan)
        out = dict(zip(keys, means.unbind()))
        out["episode_count"] = n_done
        return out

    return prog


def evaluate(argv: Sequence[str], device: torch.device | str = "cuda") -> Dict[str, float]:
    """Deterministic evaluation (mupe_tpu/harness.py:577-663, reference
    scripts/eval.py): `env.use_eval` defaults to true; the learner is warm
    started from `model_dir`; one episode of `max_episode_length` greedy
    steps; per-episode stats, `episodes`, and the 25th, 50th and 75th
    percentiles of first_capture_step over the finished episodes.  Prints
    one `key: value` line per result, sorted, as the JAX package does.
    The first observation is taken with the loaded learner's TP net (JAX's
    `evaluate` takes it with the freshly initialised one)."""
    sections, top = parse_cli(argv)
    run_cfg = apply_overrides(RunCfg(task="HideAndSeek"), top)
    if run_cfg.video:
        raise NotImplementedError(f"evaluate: {_NO_VIDEO}")
    env_over = dict(sections.get("env", {}))
    env_over.setdefault("use_eval", True)
    env, policy, _, _ = build(run_cfg.task, env_over, sections.get("algo"), run_cfg.algo, device)
    ts = None
    if run_cfg.model_dir:
        template = {k: torch.zeros((1,) + s) for k, s in env.obs_groups().items()}
        ts = load_checkpoint(run_cfg.model_dir, target=policy.init(
            template, torch.Generator().manual_seed(run_cfg.seed)))
    gen = torch.Generator(device=device).manual_seed(run_cfg.seed)
    carry = init_carry(env, policy, gen, ts=ts)
    keys, sums, n_done, capture = _greedy_episode(
        env, policy, carry.ts, carry.env_state, carry.obs, gen)
    n = float(n_done)
    if n == 0:
        # the stats would read as real 0.0s: say so
        print("WARNING: no episode finished within max_episode_length; "
              "episode stats are undefined (reported as nan)")
    result = {k: (float(v) / n if n else math.nan) for k, v in zip(keys, sums.tolist())}
    result["episodes"] = n
    if n:
        caps = capture[~torch.isnan(capture)].cpu().numpy()
        for q in (25, 50, 75):
            result[f"first_capture_step_p{q}"] = float(np.percentile(caps, q))
    for k in sorted(result):
        print(f"{k}: {result[k]:.4f}")
    return result
