"""Experiment harness: build env + policy from config, run the training loop
(counterpart of mupe_tpu/harness.py).

`train` publishes the JAX package's headline metrics under the same names
(`rollout_fps`, `rollout_fps_med`, `rollout_fps_avg`, `env_frames`, the
update's metrics and `stats/<episode stat>`), writes them to a CSV (and
wandb, if enabled), and saves the learner state and the full carry.

Not ported yet (each raises NotImplementedError): algorithms other than
MAPPO (`train_rma` among them), the Hover task, in-training evaluation and
its video (`eval_interval > 0`, `video`), the NaN guard (`guard_nan`) and the
profiler hook (`profile_dir`); `evaluate` and `train_deploy`'s own script.
"""
from __future__ import annotations

import dataclasses
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
from .utils.logging import RunLogger, config_dict


def build(
    task: str,
    env_overrides: Optional[Dict[str, Any]] = None,
    algo_overrides: Optional[Dict[str, Any]] = None,
    algo: str = "mappo",
    device: torch.device | str = "cuda",
):
    """(env, policy, env_cfg, algo_cfg) for a registered task (the env class
    and its `cfg_cls`) and MAPPO.  The policy's TP-net settings follow the
    env's first, so `algo.*` overrides still win
    (mupe_tpu/learning/registry.py `_mk_cfg`)."""
    if algo.lower() != "mappo":
        raise NotImplementedError(f"algo {algo!r} is not ported yet (MAPPO only)")
    if task not in ENV_REGISTRY:
        raise NotImplementedError(f"task {task!r} is not ported yet; have {sorted(ENV_REGISTRY)}")
    env_cls = ENV_REGISTRY[task]
    env_cfg = apply_overrides(env_cls.cfg_cls(), env_overrides or {})
    env = env_cls(env_cfg, device=device)
    algo_cfg = dataclasses.replace(
        MAPPOCfg(), use_tp_net=env_cfg.use_tp_net,
        future_prediction_step=env_cfg.future_prediction_step, window_step=env_cfg.window_step)
    algo_cfg = apply_overrides(algo_cfg, algo_overrides or {})
    policy = MAPPOPolicy(algo_cfg, n_agents=env.num_agents, action_dim=env.action_dim,
                         obs_is_dict=True, tp_input_dim=env_cfg.tp_input_dim, device=device,
                         tp_history_step=env_cfg.history_step)
    return env, policy, env_cfg, algo_cfg


def _check_ported(run_cfg: RunCfg) -> None:
    """Raise for the run options not ported yet (`build` raises for the
    algorithm and the task)."""
    deferred = {
        "eval_interval > 0 (in-training evaluation)": run_cfg.eval_interval > 0,
        "video (evaluation video)": bool(run_cfg.video),
        "guard_nan": run_cfg.guard_nan,
        "profile_dir": bool(run_cfg.profile_dir),
    }
    for what, on in deferred.items():
        if on:
            raise NotImplementedError(f"train: {what} is not ported yet")


def train(
    argv: Sequence[str],
    default_task: str = "HideAndSeek",
    deploy_stage: bool = False,
    device: torch.device | str = "cuda",
) -> Dict[str, float]:
    """The training loop (mupe_tpu/harness.py:75-241): `max_iters` or
    `total_frames`, a log row every `log_interval` iterations, a checkpoint
    every `save_interval` and at the end, `model_dir` warm start and
    `resume_dir` exact resume.  `deploy_stage=True` threads the iteration
    into the env's `update_epoch`, so the smoothness reward ramps.  Returns
    the last log row's values and `total_time_s`."""
    sections, top = parse_cli(argv)
    run_cfg = apply_overrides(RunCfg(task=default_task), top)
    _check_ported(run_cfg)
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
    for i in range(num_iters):
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
        if run_cfg.save_interval > 0 and (i + 1) % run_cfg.save_interval == 0:
            save_checkpoint(ckpt_dir, i + 1, carry.ts)
            save_checkpoint(ckpt_dir / "full", i + 1, carry)
    save_checkpoint(ckpt_dir, num_iters, carry.ts)
    save_checkpoint(ckpt_dir / "full", num_iters, carry)
    logger.close()
    last_metrics["total_time_s"] = time.time() - t_start
    return last_metrics
