"""HideAndSeek + Adaptive Environment Generator (counterpart of
mupe_tpu/envs/hideandseek_envgen.py).

The same pursuit-evasion task, but reset tasks come from a particle buffer
of intermediate-difficulty tasks (`GenBufferState`) mixed with uniform
sampling.  The AEG cycle:
  * every `eval_iter` episodes, draw a fresh task set: `ratio_unif` uniform,
    the rest noise-expanded from the history buffer;
  * each task set is replayed `eval_iter` times; per-env success is averaged;
  * tasks with success in [r_min, r_max] enter the history buffer,
    farthest-point downsampled to capacity (the FPS kernel on the card);
  * if overall success exceeds success_threshold, fall back to pure uniform.

Episodes are synchronized, and `HideAndSeek.step` reads its reset gate on
the host once a step; where the JAX package takes `lax.cond` on `any_done`,
`cycle_done` and `resample_needed`, the port branches on the host as well
(one more scalar read per reset, none per step).

Across ranks (`mupe_tpu_torch/parallel`) the buffer is replicated: every
rank holds the global task set and weights, the per-arena success is
all-gathered at a reset, `update_history` (with its FPS launch) runs on the
same pool on every rank, tasks are drawn at the global count, and each rank
places its own arenas' tasks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..native import generate_easy_tasks
from ..parallel import dist
from ..utils import trace
from .base import register_env
from .genbuffer import GenBufferState, insert_weights, sample_nearby, update_history
from .hideandseek import HideAndSeek, HideAndSeekCfg, HideAndSeekState
from .placement import grid_to_continuous
from .scenarios import INVALID_Z


@dataclasses.dataclass(frozen=True)
class HideAndSeekEnvgenCfg(HideAndSeekCfg):
    """AEG knobs (reference cfg/task/HideAndSeek_envgen.yaml); the fields and
    defaults of the JAX package's HideAndSeekEnvgenCfg."""

    use_particle_generator: bool = True
    use_init_easy_cases: bool = False
    ratio_unif: float = 0.3
    eval_iter: int = 3
    success_threshold: float = 1.0
    expand_cylinders: bool = False
    expand_step: float = 0.1
    r_min: float = 0.5
    r_max: float = 0.9
    buffer_length: int = 5000
    # starvation fallback: after `starve_cycles` consecutive cycles that add
    # no task, the effective uniform mix rises to `starve_ratio_unif`
    # (0 disables)
    starve_cycles: int = 0
    starve_ratio_unif: float = 1.0

    @property
    def task_dim(self) -> int:
        # [drone (n·3), target (3), cylinders (C·3)]
        return 3 * self.num_agents + 3 + 3 * self.num_cylinders


def envgen_extra_stats(num_cylinders: int):
    """Per-instance stat keys: the cylinder strata run 0..num_cylinders."""
    return (
        ("add_history", "history_buffer", "ratio_unif", "dry_cycles")
        + tuple(f"ratio_cylinders_{i}" for i in range(num_cylinders + 1))
        + tuple(f"success_cylinders_{i}" for i in range(num_cylinders + 1))
    )


@register_env("HideAndSeek_envgen")
class HideAndSeekEnvgen(HideAndSeek):
    """AEG task variant; shares the step machinery with HideAndSeek."""

    cfg_cls = HideAndSeekEnvgenCfg

    def __init__(
        self, cfg: HideAndSeekEnvgenCfg = HideAndSeekEnvgenCfg(),
        device: torch.device | str = "cuda",
        shard: Optional[dist.EnvShard] = None,
    ):
        super().__init__(cfg, device=device, shard=shard)
        self._extra_stats = envgen_extra_stats(cfg.num_cylinders)
        # the host-side BFS bootstrap runs once, here
        self._easy_tasks = self._easy_history() if cfg.use_init_easy_cases else None

    # -------------------------------------------------------------- tasks
    def _tasks_to_scene(self, tasks: torch.Tensor):
        """Flat task vectors → (drone_pos, target_pos, cylinders)."""
        cfg: HideAndSeekEnvgenCfg = self.cfg
        e, n = tasks.shape[0], cfg.num_agents
        drone_pos = tasks[..., : 3 * n].reshape(e, n, 3)
        target_pos = tasks[..., 3 * n : 3 * n + 3].reshape(e, 1, 3)
        cylinders = tasks[..., 3 * n + 3 :].reshape(e, cfg.num_cylinders, 3)
        return drone_pos, target_pos, cylinders

    def _scene_to_tasks(self, drone_pos, target_pos, cylinders) -> torch.Tensor:
        e = drone_pos.shape[0]
        return torch.cat(
            [drone_pos.reshape(e, -1), target_pos.reshape(e, -1), cylinders.reshape(e, -1)],
            dim=-1,
        )

    def _uniform_tasks(self, gen: torch.Generator) -> torch.Tensor:
        """Uniform task sampling through the base scene sampler, for every
        arena (the ranks' rows gathered)."""
        drone_pos, _, target_pos, cylinders, _, _ = self._sample_scene(gen)
        return dist.all_gather_envs(self._scene_to_tasks(drone_pos, target_pos, cylinders))

    def _easy_history(self, seed: int = 0) -> torch.Tensor:
        """Bootstrap tasks: the evader on a random free cell, the pursuers on
        the nearest free cells by BFS, every cylinder parked underground
        (the native C++ generator, `mupe_tpu_torch/native`)."""
        cfg: HideAndSeekEnvgenCfg = self.cfg
        cells = generate_easy_tasks(cfg.buffer_length, self.grid.num_grid, cfg.num_agents, seed)
        xy = grid_to_continuous(torch.as_tensor(cells), self.grid).numpy()
        rng = np.random.default_rng(seed)
        z = (
            rng.uniform(-0.1, 0.1, size=(cfg.buffer_length, cfg.num_agents + 1, 1))
            + cfg.max_height / 2
        ).astype(np.float32)
        drone_target = np.concatenate([xy, z], axis=-1)  # [L, n+1, 3]
        cyl = np.zeros((cfg.buffer_length, cfg.num_cylinders, 3), np.float32)
        cyl[..., 0] = np.arange(cfg.num_cylinders) * 2 * cfg.cylinder_size
        cyl[..., 2] = INVALID_Z
        tasks = np.concatenate(
            [
                drone_target[:, : cfg.num_agents].reshape(cfg.buffer_length, -1),
                drone_target[:, cfg.num_agents :].reshape(cfg.buffer_length, -1),
                cyl.reshape(cfg.buffer_length, -1),
            ],
            axis=-1,
        )
        return torch.as_tensor(tasks, device=self.device)

    # -------------------------------------------------------------- reset
    @torch.no_grad()
    def reset(
        self,
        gen: torch.Generator,
        fresh: Optional[HideAndSeekState] = None,
        tasks: Optional[torch.Tensor] = None,
    ) -> HideAndSeekState:
        """A fresh state placed on uniform tasks, with a new task buffer.
        `fresh` and `tasks` (every arena's) may be given instead of drawn
        from `gen`."""
        cfg: HideAndSeekEnvgenCfg = self.cfg
        state = super().reset(gen) if fresh is None else fresh
        if tasks is None:
            tasks = self._uniform_tasks(gen)
        gb = GenBufferState.create(cfg.buffer_length, self.shard.total, cfg.task_dim,
                                   cfg.ratio_unif, device=self.device)
        gb.eval_tasks = tasks
        if cfg.use_init_easy_cases:
            gb.history = self._easy_tasks.clone()
            gb.history_len = torch.tensor(cfg.buffer_length, dtype=torch.int32,
                                          device=self.device)
        state = dataclasses.replace(state, gen=gb)
        return self._apply_tasks(state, tasks)

    def _apply_tasks(self, state: HideAndSeekState, tasks: torch.Tensor) -> HideAndSeekState:
        """Place drones, target and cylinders at this rank's rows of
        `tasks` (every arena's; positions only) and re-prime the TP history
        for them."""
        drone_pos, target_pos, cylinders = self._tasks_to_scene(self.shard.rows(tasks))
        state = dataclasses.replace(
            state,
            drone=dataclasses.replace(state.drone, pos=drone_pos),
            target_pos=target_pos,
            cylinders=cylinders,
        )
        frame = self._tp_frame(state)
        state.history = frame[:, None, :].repeat(1, self.cfg.history_step, 1)
        return state

    # -------------------------------------------------------------- AEG hook
    def _auto_reset(
        self,
        mid: HideAndSeekState,
        st,
        done_env: torch.Tensor,
        gen: Optional[torch.Generator] = None,
        fresh: Optional[HideAndSeekState] = None,
        unif: Optional[torch.Tensor] = None,
        nearby: Optional[torch.Tensor] = None,
    ) -> HideAndSeekState:
        """The base reset plus one AEG step (hideandseek_envgen.py:205-327).
        `fresh`, `unif` (uniform tasks) and `nearby` (buffer tasks) may be
        given instead of drawn from `gen` (`unif` and `nearby` for every
        arena).  Across ranks the flags, the success and the task draws are
        global, so every rank's buffer takes the same step."""
        cfg: HideAndSeekEnvgenCfg = self.cfg
        if not (cfg.use_particle_generator and cfg.use_random_cylinder):
            return super()._auto_reset(mid, st, done_env, gen, fresh)
        gb: GenBufferState = mid.gen
        e = self.shard.total
        dev = self.device
        any_done = dist.any_across(done_env)

        # success > threshold ⇒ pure uniform
        if any_done:
            success = dist.all_gather_envs(st["success"][:, 0])   # [E], every arena's
            gb = dataclasses.replace(gb, ratio_unif=torch.where(
                torch.mean(success) > cfg.success_threshold,
                torch.ones_like(gb.ratio_unif), gb.ratio_unif))
            gb = insert_weights(gb, success)
            gb = dataclasses.replace(gb, update_iter=gb.update_iter + 1)
        with trace.span("sync.aeg_update_iter"):
            update_iter = int(gb.update_iter)

        # close the eval cycle: filter into the history (+ FPS)
        cycle_done = any_done and update_iter >= cfg.eval_iter
        num_added = torch.zeros((), device=dev)
        if cycle_done:
            gb, added = update_history(gb, cfg.r_min, cfg.r_max)
            num_added = added.to(torch.float32)
            update_iter = 0
            gb = dataclasses.replace(gb, update_iter=torch.zeros_like(gb.update_iter))

        # starvation fallback
        eff_ratio = gb.ratio_unif
        if cfg.starve_cycles > 0:
            if cycle_done:
                gb = dataclasses.replace(gb, dry_cycles=torch.where(
                    num_added > 0, torch.zeros_like(gb.dry_cycles), gb.dry_cycles + 1))
            eff_ratio = torch.where(
                gb.dry_cycles >= cfg.starve_cycles,
                torch.clamp(gb.ratio_unif, min=cfg.starve_ratio_unif), gb.ratio_unif)

        new_state = super()._auto_reset(mid, st, done_env, gen, fresh)

        # a new cycle draws a new task set: the first E - num_buffer uniform,
        # the rest from the buffer
        tasks = gb.eval_tasks
        if any_done and update_iter == 0:
            num_buffer = torch.minimum(
                gb.history_len, (e * (1.0 - eff_ratio)).to(torch.int32))
            if unif is None:
                unif = self._uniform_tasks(gen)
            if nearby is None:
                nearby = sample_nearby(
                    gen, gb, e, self.grid, cfg.num_agents, cfg.num_cylinders,
                    cfg.expand_step, cfg.expand_cylinders, cfg.arena_size, cfg.max_height)
            use_buffer = torch.arange(e, device=dev) >= (e - num_buffer)
            tasks = torch.where(use_buffer[:, None], nearby, unif)
            gb = dataclasses.replace(gb, eval_tasks=tasks)

        # place the tasks in the envs that reset (all of them: synchronized)
        placed = self._apply_tasks(new_state, tasks)
        d3 = done_env[:, None, None]
        new_state = dataclasses.replace(
            new_state,
            drone=dataclasses.replace(
                new_state.drone, pos=torch.where(d3, placed.drone.pos, new_state.drone.pos)),
            target_pos=torch.where(d3, placed.target_pos, new_state.target_pos),
            cylinders=torch.where(d3, placed.cylinders, new_state.cylinders),
            history=torch.where(d3, placed.history, new_state.history),
        )

        # AEG bookkeeping stats
        stats = dict(new_state.stats)
        active = torch.sum(tasks[..., 3 * cfg.num_agents + 5 :: 3] > 0.0, dim=-1)
        ones = torch.ones((cfg.num_envs, 1), device=dev)
        w = gb.weight_sum / torch.clamp(gb.weight_count, min=1)
        for i in range(cfg.num_cylinders + 1):
            mask_i = active == i
            stats[f"ratio_cylinders_{i}"] = ones * torch.mean(mask_i.to(torch.float32))
            stats[f"success_cylinders_{i}"] = ones * (
                torch.sum(w * mask_i) / torch.clamp(torch.sum(mask_i), min=1))
        stats["add_history"] = ones * num_added
        stats["history_buffer"] = ones * gb.history_len.to(torch.float32)
        stats["ratio_unif"] = ones * eff_ratio  # effective (with the starvation boost)
        stats["dry_cycles"] = ones * gb.dry_cycles.to(torch.float32)
        return dataclasses.replace(new_state, stats=stats, gen=gb)

    def _fresh(self, gen: torch.Generator, v_prey, update_epoch) -> HideAndSeekState:
        state = super()._fresh(gen, v_prey, update_epoch)
        extra = {k: torch.zeros((self.cfg.num_envs, 1), device=self.device)
                 for k in self._extra_stats}
        state.stats = {**state.stats, **extra}
        return state
