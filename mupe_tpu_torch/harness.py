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
AEG and sim-free variants, and Hover.  Algorithms (`algo=`, through
`learning/registry.py`): mappo (every option: per-agent actors, the
centralized critic, the relation encoders), ppo (with the privileged
branches over Hover's domain-randomized dict observations), ppo_tconv,
ppo_sdf, transformer, the recurrent ppo_rnn, whose carry threads the GRU
states (`init_rnn_carry`, `make_rnn_train_iter`), ppo_vision over Hover's
depth camera (`env.obs_depth=true`; `algo.vision_encoder=conv |
mobilenet_v3_small | mobilenet_v3_large`), and ppo_adapt, whose three RMA
phases `train_rma` runs back to back.

Not ported (raises NotImplementedError): evaluation videos (`video`:
`utils/render.py` draws with matplotlib, which the port does not depend
on).
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
from .learning import init_carry, make_train_iter
from .learning.optim import AdamState
from .learning.ppo.ppo_adapt import LOG_STD_PATH
from .learning.registry import is_recurrent, make_policy
from .learning.rollout import (init_rnn_carry, make_rnn_train_iter, make_rollout,
                               obs_template)
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
    and its `cfg_cls`) and algorithm (mupe_tpu/harness.py:40-57): the
    policy comes from the registry (`make_policy`), whose cfg threads an
    env's TP-net settings in before the `algo.*` overrides.  The TP net's
    prediction in the observation is MAPPO's alone, so for any other
    algorithm the env's `use_tp_net` is turned off."""
    if task not in ENV_REGISTRY:
        raise NotImplementedError(f"task {task!r} is not ported yet; have {sorted(ENV_REGISTRY)}")
    env_cls = ENV_REGISTRY[task]
    env_cfg = apply_overrides(env_cls.cfg_cls(), env_overrides or {})
    if algo.lower() != "mappo" and hasattr(env_cfg, "use_tp_net"):
        env_cfg = dataclasses.replace(env_cfg, use_tp_net=False)
    env = env_cls(env_cfg, device=device)
    policy = make_policy(algo, env, algo_overrides, device)
    return env, policy, env_cfg, policy.cfg


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
    if run_cfg.algo == "ppo_adapt":
        return train_rma(run_cfg, sections, device)
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
    recurrent = is_recurrent(policy)
    carry = (init_rnn_carry if recurrent else init_carry)(env, policy, gen)
    if run_cfg.model_dir:
        # warm start: the learner state only
        carry.ts = load_checkpoint(run_cfg.model_dir, target=carry.ts)
    if run_cfg.resume_dir:
        # exact resume: the full carry (learner, env state with the AEG
        # buffer and curriculum scalars, last observation, the GRU states,
        # generator)
        carry = load_checkpoint(run_cfg.resume_dir, target=carry)
    train_iter = (make_rnn_train_iter if recurrent else make_train_iter)(env, policy)
    if run_cfg.guard_nan:
        # skip updates whose loss went non-finite instead of corrupting the
        # run: a copy of the carry and one scalar host sync an iteration
        train_iter = guard_train_iter(train_iter)
    eval_prog = (_make_eval_prog(env, policy, run_cfg.seed, recurrent)
                 if run_cfg.eval_interval > 0 else None)

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


# Hover's randomization ranges (reference cfg/task/Hover.yaml) and history,
# which train_rma sets where the run gives no dr_* key / no history length
RMA_HOVER_DR = dict(dr_mass_scale=(0.8, 1.2), dr_t2w_scale=(0.9, 1.1), dr_drag_scale=(0.5, 1.5))
RMA_HOVER_HISTORY = 32
RMA_PHASES = {"encoder": 1, "adaptation": 2, "finetune": 3}


def rma_phase_lengths(total_iters: int):
    """(n1, n2, n3): half the iterations for the encoder phase, a quarter
    for the adaptation phase, the rest (at least one each) for finetuning."""
    n1 = max(1, total_iters // 2)
    n2 = max(1, total_iters // 4)
    return n1, n2, max(1, total_iters - n1 - n2)


def _init_generator(gen: torch.Generator) -> torch.Generator:
    """A CPU generator for parameter initialisation, seeded from `gen`."""
    seed = int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device).item())
    return torch.Generator().manual_seed(seed)


def train_rma(run_cfg: RunCfg, sections: Dict[str, Dict[str, Any]],
              device: torch.device | str = "cuda") -> Dict[str, float]:
    """RMA's three phases for `algo=ppo_adapt`, back to back
    (mupe_tpu/harness.py:325-531):

      1. encoder: PPO with the privileged context z = E(intrinsics);
      2. adaptation: the policy frozen; each iteration rolls out with the
         phase-2 policy (acting from z^ = A(history)) and takes one
         `update_adaptation` step over all T * E * n rows, supervised by
         the phase-1 actor's encoder;
      3. finetune: acting from z^, PPO trains the adaptation module with the
         actor body, from fresh optimiser states.

    Phase 2 starts from a fresh adaptation module beside the phase-1 actor
    body (`_AdaptActor_0`, log_std), the phase-1 critic (its own encoder
    included) and value normaliser.  Log rows carry `rma_phase`; the learner
    and the full carry are saved at the end.  `model_dir` and `resume_dir`
    load the phase-1 learner / carry, and phase 1 starts over."""
    env_over = dict(sections.get("env") or {})
    algo_over = dict(sections.get("algo") or {})
    if run_cfg.task == "Hover":
        if not any(k.startswith("dr_") for k in env_over):
            for k, v in RMA_HOVER_DR.items():
                env_over.setdefault(k, v)
        env_over.setdefault("obs_history_len", RMA_HOVER_HISTORY)
    env, policy1, env_cfg, algo_cfg = build(run_cfg.task, env_over, algo_over, "ppo_adapt",
                                            device)
    run_name = run_cfg.run_name or time.strftime("%Y%m%d-%H%M%S")
    ckpt_dir = Path(run_cfg.run_dir) / run_name / "checkpoints"
    logger = RunLogger(
        run_cfg.run_dir, run_name, wandb_mode=run_cfg.wandb_mode,
        wandb_project=run_cfg.wandb_project, wandb_entity=run_cfg.wandb_entity,
        config=config_dict(run_cfg, env_cfg, algo_cfg),
    )
    frames_per_iter = env.num_envs * algo_cfg.train_every
    if run_cfg.max_iters > 0:
        total_iters = run_cfg.max_iters
    else:
        total_iters = max(4, run_cfg.total_frames // frames_per_iter)
    n1, n2, n3 = rma_phase_lengths(total_iters)
    env_frames, last = 0, {}

    def run_phase(carry, n_iters: int, phase: str, step):
        """`n_iters` of `step(carry) -> (carry, metrics, ep_stats)`, a log
        row every `log_interval` iterations and at the phase's end."""
        nonlocal env_frames, last
        t_block = time.time()
        for i in range(n_iters):
            carry, metrics, ep_stats = step(carry)
            env_frames += frames_per_iter
            if (i + 1) % run_cfg.log_interval == 0 or i == n_iters - 1:
                row = {**{k: float(v) for k, v in metrics.items()},
                       **{f"stats/{k}": float(v) for k, v in ep_stats.items()}}
                now = time.time()
                row.update(rollout_fps=frames_per_iter * min(run_cfg.log_interval, i + 1)
                           / max(now - t_block, 1e-9),
                           env_frames=env_frames, rma_phase=RMA_PHASES[phase])
                t_block = now
                logger.log(row, step=env_frames)
                last = {k: float(v) for k, v in row.items()}
        return carry

    # ---- phase 1: encoder
    gen = torch.Generator(device=device).manual_seed(run_cfg.seed)
    carry = init_carry(env, policy1, gen)
    if run_cfg.model_dir:
        carry.ts = load_checkpoint(run_cfg.model_dir, target=carry.ts)
    if run_cfg.resume_dir:
        carry = load_checkpoint(run_cfg.resume_dir, target=carry)
    carry = run_phase(carry, n1, "encoder", make_train_iter(env, policy1))
    ts1 = carry.ts

    # ---- phase 2: adaptation
    policy2 = make_policy("ppo_adapt", env, {**algo_over, "phase": "adaptation"}, device)
    fresh = policy2.init(carry.obs, _init_generator(carry.generator))
    p1 = ts1.actor.params()
    actor_leaves = [p1[path].detach() if path in p1 else v
                    for path, v in fresh.actor.params().items()]
    ts2 = policy2.init(carry.obs, actor_leaves=actor_leaves, log_std=ts1.log_std.detach(),
                       critic_leaves=[l.detach() for l in ts1.critic.leaves])
    ts2.value_norm = ts1.value_norm
    target_encoder = {k: v.detach() for k, v in p1.items()}
    actor_body = {**target_encoder, LOG_STD_PATH: ts1.log_std.detach()}
    critic_body = {k: v.detach() for k, v in ts1.critic.params().items()}
    carry.ts = ts2
    adaptation = policy2.adaptation_params(ts2)
    adapt_opt = AdamState.zeros_like([adaptation.detach()])
    gan = policy2.adapt_cfg.adaptation_loss in ("gan", "lsgan")
    disc, disc_opt = (policy2.init_discriminator(_init_generator(carry.generator)) if gan
                      else (None, None))
    rollout = make_rollout(env, policy2)

    def adapt_iter(carry):
        nonlocal adapt_opt, disc, disc_opt
        carry, traj, ep_stats = rollout(carry)
        obs = {k: v.reshape((-1,) + tuple(v.shape[3:])) for k, v in traj["obs"].items()}
        out = policy2.update_adaptation(
            adaptation.detach(), adapt_opt, target_encoder, obs["observation_h"],
            obs["intrinsics"], obs=obs["observation"], actor_params=actor_body,
            critic_params=critic_body, disc=disc, disc_opt=disc_opt)
        with torch.no_grad():
            adaptation.copy_(out[0])
        adapt_opt = out[1]
        metrics = {"adaptation_loss": out[2]}
        if gan:
            disc, disc_opt = out[3], out[4]
            metrics["disc_loss"] = out[5]
        return carry, metrics, ep_stats

    carry = run_phase(carry, n2, "adaptation", adapt_iter)

    # ---- phase 3: finetune, from the phase-2 parameters and fresh optimisers
    policy3 = make_policy("ppo_adapt", env, {**algo_over, "phase": "finetune"}, device)
    carry.ts.actor_opt = AdamState.zeros_like(carry.ts.actor_params())
    carry.ts.critic_opt = AdamState.zeros_like(carry.ts.critic_params())
    carry = run_phase(carry, n3, "finetune", make_train_iter(env, policy3))

    save_checkpoint(ckpt_dir, total_iters, carry.ts)
    save_checkpoint(ckpt_dir / "full", total_iters, carry)
    logger.close()
    return last


@torch.no_grad()
def _greedy_episode(env, policy, ts, env_state, obs, gen: torch.Generator, state=None,
                    recurrent: bool = False):
    """`max_episode_length` greedy steps (`deterministic=True`) from
    `env_state` and its observation `obs` (and the critic state `state`,
    which the centralized critic reads); a recurrent policy threads GRU
    states from zeros, `is_init` set at the start and after each episode's
    end (the JAX package's eval semantics).  Returns (stat keys, the
    done-masked sum of each stat [K], the number of finished episodes, and
    each step's first_capture_step where an episode finished, NaN elsewhere
    [T, E], or None for an env without that stat).  The sums accumulate step
    by step: no trajectory is kept."""
    provides_tp = getattr(env, "provides_tp", False)
    step_args = (ts.tp_net if policy.cfg.use_tp_net else None,) if provides_tp else ()
    state_kw = {"state": state} if policy.cfg.critic_input == "state" else {}
    if recurrent:
        a_rnn = c_rnn = policy.zero_state(obs.shape[:-1])
        is_init = torch.ones(obs.shape[:-1] + (1,), dtype=torch.bool, device=obs.device)
    keys, sums, n_done, capture = None, 0.0, 0.0, []
    for _ in range(env.cfg.max_episode_length):
        if recurrent:
            action, _, _, a_rnn, c_rnn = policy.act(ts, obs, a_rnn, c_rnn, is_init,
                                                    deterministic=True)
        else:
            action, _, _ = policy.act(ts, obs, deterministic=True, **state_kw)
        env_state, tr = env.step(env_state, action, gen, *step_args)
        if recurrent:
            is_init = tr.done[:, :, None].expand(is_init.shape).to(torch.bool)
        if state_kw:
            state_kw["state"] = tr.info.get("state")
        done = tr.done.float()                                      # [E, 1]
        keys = keys or list(tr.stats)  # one order for every step
        stats = torch.cat([tr.stats[k] for k in keys], dim=1)       # [E, K]
        sums = sums + torch.sum(stats * done, dim=0)
        n_done = n_done + torch.sum(done)
        if "first_capture_step" in tr.stats:
            capture.append(torch.where(tr.done, tr.stats["first_capture_step"], math.nan)[:, 0])
        obs = tr.obs
    return keys, sums, n_done, torch.stack(capture) if capture else None


def _make_eval_prog(env, policy, seed: int, recurrent: bool = False):
    """One-episode greedy evaluation (mupe_tpu/harness.py:244-322):
    `prog(ts, i)` resets the training env's configuration afresh from a
    generator of its own, seeded from `seed + 7919` and the iteration `i`
    (JAX: `fold_in(PRNGKey(seed + 7919), i)`), acts greedily for
    `max_episode_length` steps and returns the done-masked mean of every
    stat (NaN where no episode finished) and `episode_count`.  It neither
    reads nor advances the training carry or its generator.  `recurrent`
    threads GRU states from zeros (mupe_tpu/harness.py:244-323)."""

    def prog(ts, i: int) -> Dict[str, torch.Tensor]:
        gen = torch.Generator(device=env.device).manual_seed((seed + 7919) * 2**32 + i)
        env_state = env.reset(gen)
        if getattr(env, "provides_tp", False):
            obs, state = env.observe_full(env_state, getattr(ts, "tp_net", None))
        else:
            obs, state = env.observe(env_state), None
        keys, sums, n_done, _ = _greedy_episode(env, policy, ts, env_state, obs, gen, state,
                                                recurrent)
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
    if is_recurrent(policy):
        raise ValueError(f"evaluate takes non-recurrent policies, as the JAX package's does "
                         f"(its init_carry cannot build algo={run_cfg.algo!r}); evaluate a "
                         "recurrent policy in training with eval_interval")
    ts = None
    if run_cfg.model_dir:
        ts = load_checkpoint(run_cfg.model_dir, target=policy.init(
            obs_template(env), torch.Generator().manual_seed(run_cfg.seed)))
    gen = torch.Generator(device=device).manual_seed(run_cfg.seed)
    carry = init_carry(env, policy, gen, ts=ts)
    keys, sums, n_done, capture = _greedy_episode(
        env, policy, carry.ts, carry.env_state, carry.obs, gen, carry.state)
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
