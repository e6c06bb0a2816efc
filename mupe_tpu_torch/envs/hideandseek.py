"""HideAndSeek: 3-pursuer vs 1-evader pursuit-evasion in a cylinder arena.

Counterpart of mupe_tpu/envs/hideandseek.py: random cylinders with
path-feasible re-draws, uniform or curriculum-bounded spawns, the fixed
evaluation scenarios (with optional jitter), eval spawn/scenario mixing in
training resets, the scripted evader, LoS-blocked detection, the TP-net
prediction in the observation, the cooperative capture reward with its
penalties, per-episode stat normalization, the evader-speed curriculum and
auto-reset.

Randomness comes from an explicit `torch.Generator` on the env's device.
The env is never differentiated: reset, observe and step run without
autograd.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..controllers import PIDRateState
from ..core import euler_to_quaternion
from ..dynamics import DroneState, RigidBodyCfg, hover_state, make_params
from ..dynamics import step as dynamics_step
from ..learning.tp_net import denormalize_predictions, normalize_groundtruth
from ..parallel import dist
from ..transforms.ctbr import hover_prev_action_init, pid_rate_transform
from ..utils import graphs, trace
from .base import Transition, register_env, where_done
from .geometry import k_nearest_cylinders, line_blocked_by_cylinder
from .placement import (
    feasible_layout,
    largest_feasible_prefix,
    make_grid,
    outside_circle_mask,
    sample_cylinders,
    sample_spawns_cl,
)
from .prey import prey_force, prey_velocity
from .scenarios import EVAL_SCENARIOS, INVALID_Z, scenario_cylinders, scenario_spawns


@dataclasses.dataclass(frozen=True)
class HideAndSeekCfg:
    """Task hyper-parameters; same fields and defaults as the JAX package's
    HideAndSeekCfg (reference cfg/task/HideAndSeek.yaml)."""

    num_envs: int = 2048
    max_episode_length: int = 800
    dt: float = 0.01
    drone_model: str = "crazyflie"
    num_agents: int = 3
    arena_size: float = 0.9
    max_height: float = 1.2
    v_drone: float = 1.0
    v_prey: float = 1.3
    catch_radius: float = 0.3
    collision_radius: float = 0.07
    drone_detect_radius: float = 100.0
    target_detect_radius: float = 100.0
    dist_reward_coef: float = 1.0
    catch_reward_coef: float = 20.0
    detect_reward_coef: float = 0.0
    collision_coef: float = 100.0
    speed_coef: float = 10.0
    init_smoothness_coef: float = 0.0
    max_smoothness_coef: float = 5.0
    smooth_lr: float = 0.0
    use_deployment: bool = False
    cylinder_size: float = 0.1
    min_cylinders: int = 4
    max_cylinders: int = 5
    fixed_cylinders: Optional[int] = None
    obs_max_cylinder: int = 3
    scene_redraws: int = 3
    use_random_cylinder: bool = True
    scenario_flag: str = "wall"
    use_eval: bool = False
    use_cl_spawn: bool = False
    cl_bound: int = 6
    height_bound: float = 0.5
    eval_spawn_ratio: float = 0.0
    eval_scenario_ratio: float = 0.0
    eval_mix_rotate: bool = True
    eval_jitter_xy: float = 0.0
    eval_jitter_z: float = 0.0
    eval_jitter_rpy: float = 0.0
    eval_mix_scenarios: Optional[Tuple[str, ...]] = None
    use_tp_net: bool = True
    history_step: int = 10
    future_prediction_step: int = 5
    window_step: int = 1
    use_obstacles_tp: bool = False
    time_encoding_dim: int = 4
    mask_value: float = -5.0
    prey_componentwise_norm: bool = True

    @property
    def num_cylinders(self) -> int:
        return self.max_cylinders

    @property
    def tp_input_dim(self) -> int:
        base = 1 + 3 + 3 + 3 * self.num_agents
        if self.use_obstacles_tp:
            base += 3 * self.num_cylinders
        return base

    @property
    def state_self_dim(self) -> int:
        if self.use_tp_net:
            return 3 + 3 * self.future_prediction_step + self.time_encoding_dim + 13
        return 3 + self.time_encoding_dim + 13


STAT_KEYS = (
    "success",
    "collision",
    "blocked",
    "distance_reward",
    "distance_predicted_reward",
    "speed_reward",
    "collision_reward",
    "collision_wall",
    "collision_cylinder",
    "collision_drone",
    "detect_reward",
    "catch_reward",
    "smoothness_reward",
    "smoothness_mean",
    "smoothness_max",
    "first_capture_step",
    "sum_detect_step",
    "return",
    "action_error_order1_mean",
    "action_error_order1_max",
    "target_predicted_error",
    "out_of_arena",
    "smoothness_coef",
    "scene_fallback",
    "scene_degraded",
)

# stats divided by episode length at done (hideandseek.py:1017-1056)
_EP_NORMALIZED = (
    "collision",
    "action_error_order1_mean",
    "target_predicted_error",
    "distance_predicted_reward",
    "smoothness_mean",
    "smoothness_reward",
    "distance_reward",
    "detect_reward",
    "catch_reward",
    "collision_reward",
    "collision_wall",
    "collision_drone",
    "collision_cylinder",
    "speed_reward",
)


@dataclasses.dataclass
class HideAndSeekState:
    drone: DroneState              # [E, n, ·]
    pid: PIDRateState              # [E, n, ·]
    prev_action: torch.Tensor      # [E, n, 4]
    target_pos: torch.Tensor       # [E, 1, 3]
    target_vel: torch.Tensor       # [E, 1, 3]
    cylinders: torch.Tensor        # [E, C, 3] (inactive parked at z=INVALID_Z)
    progress: torch.Tensor         # [E] int32
    v_prey: torch.Tensor           # [] evader speed (curriculum)
    history: torch.Tensor          # [E, H, F] TP input window
    stats: Dict[str, torch.Tensor]  # each [E, 1]
    update_epoch: torch.Tensor     # [] smoothness ramp
    tp_pred: torch.Tensor          # [E, fut, 3] last TP prediction (world frame)
    gen: Any = None                # AEG GenBufferState (HideAndSeekEnvgen only)


@register_env("HideAndSeek")
class HideAndSeek:
    provides_tp = True
    cfg_cls = HideAndSeekCfg

    def __init__(
        self, cfg: HideAndSeekCfg = HideAndSeekCfg(), device: torch.device | str = "cuda",
        shard: Optional[dist.EnvShard] = None,
    ):
        # `cfg` is the global configuration; the env holds `shard`'s arenas
        # (all of them by default) and `self.cfg.num_envs` counts those
        cfg, self.shard = dist.local_cfg(cfg, shard)
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = make_params(cfg.drone_model, self.device)
        self.rigid_cfg = RigidBodyCfg(max_linear_velocity=cfg.v_drone)
        self.num_agents = cfg.num_agents
        self.action_dim = 4
        self.grid = make_grid(cfg.arena_size, cfg.cylinder_size)
        # (i, j) of every other drone j of drone i, row by row: the order of
        # a boolean off-diagonal mask, gathered without a host read
        self._offdiag = tuple(ix.to(self.device) for ix in
                              (~torch.eye(cfg.num_agents, dtype=torch.bool)).nonzero(as_tuple=True))
        # the step's two segments, replayed as CUDA graphs on a card; the
        # tensors they read besides their inputs
        self._graph_a, self._graph_b = graphs.Graphed(), graphs.Graphed()
        self._constants = graphs.flatten((self.params, self._offdiag))[0]
        if cfg.num_agents > 4 and (cfg.use_eval or not cfg.use_random_cylinder):
            # the fixed spawn tables (reference hideandseek.py:632-682) only
            # define 4 pursuer slots; silently broadcasting would alias spawns
            raise ValueError(
                "fixed eval/scenario spawn tables support at most 4 agents; "
                f"got num_agents={cfg.num_agents}")

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        if not cfg.use_random_cylinder:
            cyl, _ = scenario_cylinders(cfg.scenario_flag, cfg.num_cylinders,
                                        cfg.cylinder_size, cfg.max_height)
            d, t = scenario_spawns(cfg.scenario_flag, cfg.num_agents)
            self._scenario_cyl, self._spawn_drone, self._spawn_target = dev(cyl), dev(d), dev(t)
        if cfg.eval_spawn_ratio > 0.0 or cfg.eval_scenario_ratio > 0.0:
            if cfg.num_agents > 4:
                raise ValueError("eval spawn/scenario mixing needs the 4-slot fixed "
                                 f"spawn tables; got num_agents={cfg.num_agents}")
            mix_scen = (tuple(cfg.eval_mix_scenarios) if cfg.eval_mix_scenarios is not None
                        else EVAL_SCENARIOS)
            for f in mix_scen:
                if f not in EVAL_SCENARIOS:
                    raise ValueError(f"unknown eval scenario {f!r}")
            # spawn tables: every scenario (spawns need no cylinder capacity)
            spawns = [scenario_spawns(f, cfg.num_agents) for f in mix_scen]
            self._mix_spawn_d = dev(np.stack([d for d, _ in spawns]))  # [S, n, 3]
            self._mix_spawn_t = dev(np.stack([t for _, t in spawns]))  # [S, 1, 3]
            # full-scenario tables: only the layouts that fit num_cylinders
            # (passage and random need 6 active; the default capacity is 5)
            full = []
            for f in mix_scen:
                try:
                    c, _ = scenario_cylinders(f, cfg.num_cylinders, cfg.cylinder_size,
                                              cfg.max_height)
                except ValueError:
                    continue
                full.append((f, c) + scenario_spawns(f, cfg.num_agents))
            self._mix_full_scenarios = tuple(f for f, *_ in full)
            self._mix_full_cyl = dev(np.stack([c for _, c, _, _ in full]))  # [S', C, 3]
            self._mix_full_d = dev(np.stack([d for _, _, d, _ in full]))    # [S', n, 3]
            self._mix_full_t = dev(np.stack([t for _, _, _, t in full]))    # [S', 1, 3]

    @property
    def num_envs(self) -> int:
        return self.cfg.num_envs

    def _uniform(self, gen, shape, lo, hi) -> torch.Tensor:
        """U(lo, hi) of `shape`; every uniform draw of the scene goes through
        here (tests inject the JAX package's draws by replacing it)."""
        lo = trace.to_device(lo, self.device, torch.float32, "uniform_bounds")
        hi = trace.to_device(hi, self.device, torch.float32, "uniform_bounds")
        u = self.shard.draw(lambda s: torch.rand(s, generator=gen, device=self.device), shape)
        return lo + (hi - lo) * u

    def _randint(self, gen, hi: int, shape) -> torch.Tensor:
        """Integers uniform in [0, hi) (the mixing tables' choice)."""
        return self.shard.draw(
            lambda s: torch.randint(0, hi, s, generator=gen, device=self.device), shape)

    def obs_groups(self) -> Dict[str, Tuple[int, int]]:
        """(tokens, features) of each observation group of one agent."""
        cfg = self.cfg
        return {
            "state_self": (1, cfg.state_self_dim),
            "state_others": (cfg.num_agents - 1, 3),
            "cylinders": (cfg.obs_max_cylinder, 5),
        }

    # ------------------------------------------------------------- sampling
    @staticmethod
    def _rot_xy(p: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
        """Yaw-rotate [..., 3] points about the arena centre (z kept)."""
        c, s = torch.cos(theta), torch.sin(theta)
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        return torch.stack([c * x - s * y, s * x + c * y, z], dim=-1)

    def _sample_scene(self, gen: torch.Generator):
        """Spawn poses + cylinder layout for all envs
        (mupe_tpu/envs/hideandseek.py:316-529, the same branches in the same
        order).  Training draws uniform spawns (or curriculum-bounded ones)
        and a path-feasible random layout; eval mode puts the drones on
        fixed spawns, over random cylinders or a fixed scenario.  The default
        configuration draws exactly what it drew before the other branches
        existed; mixing, jitter and curriculum spawns add their own draws."""
        cfg = self.cfg
        e, n = cfg.num_envs, cfg.num_agents
        a = cfg.arena_size / math.sqrt(2.0)
        h2 = cfg.max_height / 2
        train_mode = cfg.use_random_cylinder and not cfg.use_eval
        if cfg.use_cl_spawn and train_mode:
            # curriculum-bounded grid spawns (placement.py:560-646)
            g = self.grid.num_grid
            base = outside_circle_mask(g, self.device)[None].expand(e, g, g)
            drone_pos, target_pos = sample_spawns_cl(
                gen, base, n, self.grid, cfg.max_height,
                cl_bound=cfg.cl_bound, height_bound=cfg.height_bound, shard=self.shard)
        elif train_mode:
            drone_xy = self._uniform(gen, (e, n, 2), [0.1, -a + 0.1], [a - 0.1, a - 0.1])
            target_xy = self._uniform(gen, (e, 1, 2), [-a + 0.1, -a + 0.1], [-0.1, a - 0.1])
            drone_z = self._uniform(gen, (e, n, 1), h2 - 0.1, h2 + 0.1)
            target_z = self._uniform(gen, (e, 1, 1), h2 - 0.1, h2 + 0.1)
            drone_pos = torch.cat([drone_xy, drone_z], dim=-1)
            target_pos = torch.cat([target_xy, target_z], dim=-1)
        elif cfg.use_random_cylinder:  # eval: fixed spawns (hideandseek.py:618-627)
            fixed_d = torch.tensor([[0.6, 0.0], [0.8, 0.0], [0.8, -0.2], [0.8, 0.2]],
                                   device=self.device)[:n]
            drone_z = self._uniform(gen, (e, n, 1), h2 - 0.1, h2 + 0.1)
            target_z = self._uniform(gen, (e, 1, 1), h2 - 0.1, h2 + 0.1)
            drone_pos = torch.cat([fixed_d.expand(e, n, 2), drone_z], dim=-1)
            target_pos = torch.cat(
                [torch.tensor([[-0.8, 0.0]], device=self.device).expand(e, 1, 2), target_z],
                dim=-1)
        else:  # fixed scenario
            drone_pos = self._spawn_drone.repeat(e, 1, 1)
            target_pos = self._spawn_target.repeat(e, 1, 1)
            if cfg.eval_jitter_xy > 0.0 or cfg.eval_jitter_z > 0.0:
                amp = torch.tensor([cfg.eval_jitter_xy, cfg.eval_jitter_xy, cfg.eval_jitter_z],
                                   device=self.device)
                drone_pos = drone_pos + amp * self._uniform(gen, (e, n, 3), -1.0, 1.0)
                target_pos = target_pos + amp * self._uniform(gen, (e, 1, 3), -1.0, 1.0)

        mixing = train_mode and (cfg.eval_spawn_ratio > 0.0 or cfg.eval_scenario_ratio > 0.0)

        def mix_theta():
            if cfg.eval_mix_rotate:
                return self._uniform(gen, (e, 1), 0.0, 2.0 * math.pi)
            return torch.zeros((e, 1), device=self.device)

        if mixing and cfg.eval_spawn_ratio > 0.0:
            # fixed eval spawn tables (a random scenario per env), BEFORE the
            # cylinder draw so layouts avoid the new spawns and the
            # feasibility re-draw sees the real geometry
            which = self._randint(gen, self._mix_spawn_d.shape[0], (e,))
            theta = mix_theta()
            m = self._uniform(gen, (e, 1, 1), 0.0, 1.0) < cfg.eval_spawn_ratio
            drone_pos = torch.where(m, self._rot_xy(self._mix_spawn_d[which], theta), drone_pos)
            target_pos = torch.where(m, self._rot_xy(self._mix_spawn_t[which], theta), target_pos)

        if not cfg.use_eval:
            rpy = self._uniform(
                gen, (e, n, 3), [-0.2 * math.pi, -0.2 * math.pi, 0.0],
                [0.2 * math.pi, 0.2 * math.pi, 0.2 * math.pi],
            )
        elif cfg.eval_jitter_rpy > 0.0:
            j = cfg.eval_jitter_rpy * math.pi
            rpy = self._uniform(gen, (e, n, 3), -j, j)
        else:
            rpy = torch.zeros((e, n, 3), device=self.device)
        quat = euler_to_quaternion(rpy)

        if cfg.use_random_cylinder:
            cylinders, fallback, degraded = self._random_cylinders(
                gen, drone_pos[..., :2], target_pos[..., :2])
        else:
            cylinders = self._scenario_cyl.repeat(e, 1, 1)
            fallback = torch.zeros((e,), device=self.device)
            degraded = torch.zeros((e,), device=self.device)

        if mixing and cfg.eval_scenario_ratio > 0.0:
            # complete fixed scenario instances: layout + matching spawn
            # table, rotated together; they override the spawn mix and the
            # drawn cylinders (feasible by construction)
            which2 = self._randint(gen, self._mix_full_d.shape[0], (e,))
            theta2 = mix_theta()
            m2 = self._uniform(gen, (e, 1, 1), 0.0, 1.0) < cfg.eval_scenario_ratio
            drone_pos = torch.where(m2, self._rot_xy(self._mix_full_d[which2], theta2), drone_pos)
            target_pos = torch.where(m2, self._rot_xy(self._mix_full_t[which2], theta2),
                                     target_pos)
            cylinders = torch.where(m2, self._rot_xy(self._mix_full_cyl[which2], theta2),
                                    cylinders)
            fallback = torch.where(m2[:, 0, 0], 0.0, fallback)
            degraded = torch.where(m2[:, 0, 0], 0.0, degraded)
        return drone_pos, quat, target_pos, cylinders, fallback, degraded

    def _random_cylinders(self, gen: torch.Generator, drone_xy, target_xy):
        """A path-feasible random layout per env: (cylinders [E, C, 3],
        fallback [E], degraded [E])."""
        cfg = self.cfg
        idx = torch.arange(cfg.num_cylinders, device=self.device)[None, :]

        def draw():
            xy, active = sample_cylinders(
                gen, drone_xy, target_xy, self.grid, cfg.num_cylinders,
                cfg.min_cylinders, cfg.max_cylinders, cfg.fixed_cylinders, self.shard,
            )
            ok = feasible_layout(drone_xy, target_xy, xy, idx < active, self.grid)
            return xy, active, ok

        # bounded masked re-draws until every env has a feasible layout
        xy, active, ok = draw()
        for _ in range(cfg.scene_redraws):
            xy2, active2, ok2 = draw()
            take = (~ok) & ok2
            xy = torch.where(take[:, None, None], xy2, xy)
            active = torch.where(take[:, None], active2, active)
            ok = ok | ok2
        # envs that exhausted the re-draws keep the largest feasible prefix
        wanted = active
        best = largest_feasible_prefix(drone_xy, target_xy, xy, active, self.grid)
        active = torch.where(ok[:, None], active, best[:, None])
        fallback = ((~ok) & (active[:, 0] == 0) & (wanted[:, 0] > 0)).float()
        degraded = ((~ok) & (active[:, 0] < wanted[:, 0])).float()
        z = torch.where(idx < active, 0.5 * cfg.max_height, INVALID_Z)[..., None]
        return torch.cat([xy, z], dim=-1), fallback, degraded

    def _fresh(self, gen: torch.Generator, v_prey, update_epoch) -> HideAndSeekState:
        cfg = self.cfg
        e, n = cfg.num_envs, cfg.num_agents
        dev = self.device
        (drone_pos, quat, target_pos, cylinders, fallback,
         degraded) = self._sample_scene(gen)
        drone = hover_state(self.params, drone_pos, quat)
        stats = {k: torch.zeros((e, 1), device=dev) for k in STAT_KEYS}
        stats["first_capture_step"] = torch.full((e, 1), float(cfg.max_episode_length), device=dev)
        stats["scene_fallback"] = fallback[:, None]
        stats["scene_degraded"] = degraded[:, None]
        state = HideAndSeekState(
            drone=drone,
            pid=PIDRateState.zeros((e, n), device=dev),
            prev_action=hover_prev_action_init(self.params, drone.throttle),
            target_pos=target_pos,
            target_vel=torch.zeros((e, 1, 3), device=dev),
            cylinders=cylinders,
            progress=torch.zeros((e,), dtype=torch.int32, device=dev),
            v_prey=torch.as_tensor(v_prey, dtype=torch.float32, device=dev),
            history=torch.zeros((e, cfg.history_step, cfg.tp_input_dim), device=dev),
            stats=stats,
            update_epoch=torch.as_tensor(update_epoch, dtype=torch.float32, device=dev),
            tp_pred=torch.zeros((e, cfg.future_prediction_step, 3), device=dev),
        )
        frame = self._tp_frame(state)
        state.history = frame[:, None, :].repeat(1, cfg.history_step, 1)
        return state

    @torch.no_grad()
    def reset(self, gen: torch.Generator) -> HideAndSeekState:
        return self._fresh(gen, self.cfg.v_prey * self.cfg.v_drone, 0.0)

    # ------------------------------------------------------------- TP input
    def _detection(self, state: HideAndSeekState):
        """blocked [E, n], broadcast_detect [E, 1], target_rpos [E, n, 1, 3]."""
        blocked = line_blocked_by_cylinder(
            state.drone.pos, state.target_pos, state.cylinders, self.cfg.cylinder_size
        )
        target_rpos = state.drone.pos[:, :, None, :] - state.target_pos[:, None, :, :]
        in_range = torch.linalg.vector_norm(target_rpos, dim=-1) < self.cfg.drone_detect_radius
        detect = in_range & (~blocked[..., None])
        return blocked, torch.any(detect, dim=1), target_rpos

    def _tp_frame(self, state: HideAndSeekState, broadcast_detect=None) -> torch.Tensor:
        """One TP input frame: [t, masked target pos, masked target vel,
        drone positions (, cylinder xy + radius)]."""
        cfg = self.cfg
        e = cfg.num_envs
        if broadcast_detect is None:
            _, broadcast_detect, _ = self._detection(state)
        mask = (~broadcast_detect)[..., None]  # [E, 1, 1]
        t_pos = torch.where(mask, torch.full_like(state.target_pos, cfg.mask_value),
                            state.target_pos)
        t_vel = torch.where(mask, torch.full_like(state.target_vel, cfg.mask_value),
                            state.target_vel)
        parts = [
            state.progress.to(torch.float32)[:, None],
            t_pos.reshape(e, -1),
            t_vel.reshape(e, -1),
            state.drone.pos.reshape(e, -1),
        ]
        if cfg.use_obstacles_tp:
            cyl = torch.cat(
                [state.cylinders[..., :2],
                 torch.full((e, cfg.num_cylinders, 1), cfg.cylinder_size, device=self.device)],
                dim=-1,
            )
            parts.append(cyl.reshape(e, -1))
        return torch.cat(parts, dim=-1)

    def _tp_predict(self, tp_net, history: torch.Tensor) -> torch.Tensor:
        """TP forward (the TP-LSTM kernel on the card) + denormalization →
        predicted world positions [E, fut, 3]."""
        cfg = self.cfg
        pred_norm = tp_net(history)  # [E, 3·fut]
        return denormalize_predictions(
            pred_norm.reshape(cfg.num_envs, cfg.future_prediction_step, 3),
            cfg.arena_size, cfg.max_height,
        )

    # ------------------------------------------------------------- observe
    @torch.no_grad()
    def observe_full(self, state: HideAndSeekState, tp_net, pred=None):
        """(obs dict for actors, state dict for a centralized critic)."""
        cfg = self.cfg
        e, n = cfg.num_envs, cfg.num_agents
        d = state.drone
        sv = d.state_vector()  # [E, n, 23]
        rel = d.pos[:, :, None, :] - d.pos[:, None, :, :]   # p_i − p_j
        drone_rpos = rel[:, self._offdiag[0], self._offdiag[1]].reshape(e, n, n - 1, 3)
        cyl_masked, _, _ = k_nearest_cylinders(
            d.pos, state.cylinders, cfg.cylinder_size, cfg.max_height,
            cfg.obs_max_cylinder, cfg.mask_value,
        )
        _, broadcast_detect, target_rpos = self._detection(state)
        rpos_mask = (~broadcast_detect)[..., None, None]  # [E, 1, 1, 1]
        target_rpos_masked = torch.where(
            rpos_mask, torch.full_like(target_rpos, cfg.mask_value), target_rpos
        )
        t = (state.progress / cfg.max_episode_length).to(torch.float32)[:, None, None]
        t_enc = t.expand(e, n, cfg.time_encoding_dim)

        obs: Dict[str, torch.Tensor] = {}
        if cfg.use_tp_net:
            if pred is None:
                pred = self._tp_predict(tp_net, state.history)
            rpos_pred = (d.pos[:, :, None, :] - pred[:, None, :, :]).reshape(e, n, -1)
            extra = [rpos_pred]
        else:
            extra = []
        common = [sv[..., 3:10], sv[..., 13:19], t_enc]
        obs["state_self"] = torch.cat(
            [target_rpos_masked.reshape(e, n, -1)] + extra + common, dim=-1
        )[:, :, None, :]
        state_drones = torch.cat([target_rpos.reshape(e, n, -1)] + extra + common, dim=-1)
        obs["state_others"] = drone_rpos
        obs["cylinders"] = cyl_masked
        critic_state = {"state_drones": state_drones, "cylinders": cyl_masked}
        return obs, critic_state

    # ------------------------------------------------------------- reset hook
    def _auto_reset(
        self,
        mid: HideAndSeekState,
        st: Dict[str, torch.Tensor],
        done_env: torch.Tensor,
        gen: Optional[torch.Generator] = None,
        fresh: Optional[HideAndSeekState] = None,
    ) -> HideAndSeekState:
        """Select a fresh per-env state where done.  `fresh` may be given
        instead of sampled from `gen`."""
        if fresh is None:
            if gen is None:
                raise ValueError("an episode ended: step needs a generator to reset")
            fresh = self._fresh(gen, mid.v_prey, mid.update_epoch)

        def sel(a, b):
            return where_done(done_env, a, b)

        return dataclasses.replace(
            mid,
            drone=sel(fresh.drone, mid.drone),
            pid=sel(fresh.pid, mid.pid),
            prev_action=sel(fresh.prev_action, mid.prev_action),
            target_pos=sel(fresh.target_pos, mid.target_pos),
            target_vel=sel(fresh.target_vel, mid.target_vel),
            cylinders=sel(fresh.cylinders, mid.cylinders),
            progress=torch.where(done_env, torch.zeros_like(mid.progress), mid.progress),
            history=sel(fresh.history, mid.history),
            stats=sel(fresh.stats, st),
            tp_pred=sel(fresh.tp_pred, mid.tp_pred),
        )

    # ------------------------------------------------------------- step
    @torch.no_grad()
    def step(
        self,
        state: HideAndSeekState,
        action: torch.Tensor,
        gen: Optional[torch.Generator] = None,
        tp_net=None,
    ) -> Tuple[HideAndSeekState, Transition]:
        """One step of every arena: segment A (`_segment_a`, the action
        through the TP frame), the reset gate on the host, then segment B
        (`_segment_b`, the TP prediction and the observation).  On a card
        each segment replays as a CUDA graph (`utils/graphs.py`); the gate
        and a reset run eagerly between them.  The AEG buffer (`gen`)
        passes by reference, outside the segments."""
        cfg = self.cfg
        e = cfg.num_envs
        use_tp = cfg.use_tp_net and tp_net is not None
        mid, out = self._graph_a(functools.partial(self._segment_a, use_tp),
                                 dataclasses.replace(state, gen=None), action,
                                 reads=self._constants, flags=(use_tp,))
        mid.gen = state.gen
        st, done_env = mid.stats, out["done_env"]

        # auto-reset.  Episodes are synchronized, so a reset happens once per
        # max_episode_length steps; the gate reads done_env on the host
        # (one device→host sync per step; with ranks, the flag of every
        # rank's arenas, so all draw the fresh scene together) and skips
        # the scene resample otherwise.
        if dist.any_across(done_env):
            with trace.span("env.reset"):
                # evader speed curriculum: the mean success over every arena
                mean_success = dist.global_sum(st["success"]) / self.shard.total
                mid.v_prey = torch.where(mean_success >= 0.98,
                                         torch.clamp(state.v_prey + 0.05, max=1.3), state.v_prey)
                new_state = self._auto_reset(mid, st, done_env, gen)
        else:
            new_state = mid

        tp_reads = list(tp_net.parameters()) if use_tp else []
        obs, critic_state, pred, tp_gt, tp_done = self._graph_b(
            functools.partial(self._segment_b, tp_net), dataclasses.replace(new_state, gen=None),
            reads=self._constants + tp_reads, flags=(use_tp,))
        if pred is not None:
            new_state.tp_pred = pred
        info = {
            "drone_state": out["drone_state"],
            "ctbr": out["ctbr"],
            "prev_action": new_state.prev_action,
            "state": critic_state,
            "tp_input": new_state.history,
            "tp_gt": tp_gt,
            "tp_done": tp_done,
            "target_pos": mid.target_pos,
            "cylinders": state.cylinders,
            "capture": out["capture"],
            "tp_pred": pred if pred is not None
            else torch.zeros((e, cfg.future_prediction_step, 3), device=self.device),
        }
        return new_state, Transition(obs=obs, reward=out["reward"], done=out["done"], stats=st,
                                     info=info)

    def _segment_a(self, use_tp: bool, state: HideAndSeekState, action: torch.Tensor):
        """The step up to the reset gate: the action transform, the evader,
        the physics, detection, the reward and the stats, and the new TP
        frame.  (the state after the step, before any reset; its outputs)."""
        cfg = self.cfg
        e, n = cfg.num_envs, cfg.num_agents
        params = self.params
        dev = self.device

        with trace.span("env.action"):
            # action transform + stats bookkeeping
            res = pid_rate_transform(params, state.drone, action, state.prev_action, state.pid,
                                     cfg.dt)
            st = dict(state.stats)
            ae_mean = torch.mean(res.action_error, dim=-1, keepdim=True)
            st["action_error_order1_mean"] = st["action_error_order1_mean"] + ae_mean
            st["action_error_order1_max"] = torch.maximum(st["action_error_order1_max"], ae_mean)

        with trace.span("env.prey"):
            # evader velocity from the potential field
            force = prey_force(
                state.drone.pos, state.target_pos, state.cylinders, cfg.cylinder_size,
                cfg.arena_size, cfg.max_height, cfg.target_detect_radius,
            )
            t_vel = prey_velocity(force, state.v_prey, componentwise=cfg.prey_componentwise_norm)

        with trace.span("env.dynamics"):
            # physics: drones (with downwash) + kinematic evader
            drone, throttle_diff = dynamics_step(
                params, state.drone, res.rotor_cmds, cfg.dt, self.rigid_cfg, enable_downwash=True
            )
            target_pos = state.target_pos + cfg.dt * t_vel
            progress = state.progress + 1
            mid = dataclasses.replace(
                state, drone=drone, pid=res.pid_state, prev_action=res.ctbr_action,
                target_pos=target_pos, target_vel=t_vel, progress=progress, stats=st,
            )

        with trace.span("env.detect"):
            blocked, broadcast_detect, target_rpos = self._detection(mid)
            target_dist = torch.linalg.vector_norm(target_pos - drone.pos, dim=-1)  # [E, n]

        with trace.span("env.reward"):
            # reward (hideandseek.py:919-1006)
            active_dist = (target_dist > cfg.catch_radius).float()
            distance_reward = -cfg.dist_reward_coef * target_dist * active_dist
            st["distance_reward"] = st["distance_reward"] + distance_reward.mean(-1, keepdim=True)

            if use_tp:
                tp_valid = (state.progress > 0)[:, None].float()
                err1 = torch.linalg.vector_norm(
                    state.tp_pred[:, 0] - target_pos[:, 0], dim=-1, keepdim=True
                )
                st["target_predicted_error"] = st["target_predicted_error"] + tp_valid * err1
                dist_pred = torch.linalg.vector_norm(drone.pos - state.tp_pred[:, None, 0, :],
                                                     dim=-1)
                st["distance_predicted_reward"] = st["distance_predicted_reward"] + tp_valid * (
                    -cfg.dist_reward_coef * dist_pred.mean(-1, keepdim=True)
                )

            detect_b = broadcast_detect.expand(e, n)
            detect_reward = cfg.detect_reward_coef * detect_b.float()
            st["sum_detect_step"] = st["sum_detect_step"] + torch.any(detect_b, dim=1, keepdim=True)
            st["detect_reward"] = st["detect_reward"] + detect_reward.mean(-1, keepdim=True)

            capture = target_dist < cfg.catch_radius
            broadcast_capture = torch.any(capture & (~blocked), dim=-1, keepdim=True)
            catch_reward = cfg.catch_reward_coef * broadcast_capture.expand(e, n).float()
            capture_flag = torch.any(catch_reward > 0, dim=1, keepdim=True)
            st["blocked"] = st["blocked"] + torch.all(blocked, dim=-1, keepdim=True)
            st["success"] = torch.logical_or(capture_flag, st["success"].bool()).float()
            current_capture_step = torch.where(
                capture_flag[..., 0], progress.float(),
                torch.full_like(progress, cfg.max_episode_length, dtype=torch.float32),
            )[:, None]
            st["first_capture_step"] = torch.minimum(st["first_capture_step"], current_capture_step)
            st["catch_reward"] = st["catch_reward"] + catch_reward.mean(-1, keepdim=True)

            speed = torch.linalg.vector_norm(drone.vel, dim=-1)
            speed_reward = -cfg.speed_coef * (speed > cfg.v_drone).float()
            st["speed_reward"] = st["speed_reward"] + speed_reward.mean(-1, keepdim=True)

            # collisions: cylinders (XY), other drones, wall
            cyl_rpos_xy = mid.cylinders[:, None, :, :2] - drone.pos[:, :, None, :2]
            cyl_xy_dist = torch.linalg.vector_norm(cyl_rpos_xy, dim=-1)          # [E, n, C]
            cyl_active = (mid.cylinders[..., 2] >= 0.0)[:, None, :]
            coll_cyl = ((cyl_xy_dist - cfg.cylinder_size < cfg.collision_radius)
                        & cyl_active).float().sum(-1)
            collision_reward = -cfg.collision_coef * coll_cyl
            st["collision_cylinder"] = st["collision_cylinder"] + coll_cyl.mean(-1, keepdim=True)
            rel = drone.pos[:, :, None, :] - drone.pos[:, None, :, :]
            ddist = torch.linalg.vector_norm(rel, dim=-1) + torch.eye(n, device=dev) * 1e6
            coll_drone = (ddist < 2.0 * cfg.collision_radius).float().sum(-1)
            collision_reward = collision_reward - cfg.collision_coef * coll_drone
            st["collision_drone"] = st["collision_drone"] + coll_drone.mean(-1, keepdim=True)
            coll_wall = (drone.pos[..., 2] > cfg.max_height).float() + (
                torch.square(drone.pos[..., 0]) + torch.square(drone.pos[..., 1])
                > cfg.arena_size**2
            ).float()
            collision_reward = collision_reward - cfg.collision_coef * coll_wall
            collision_flag = torch.any(collision_reward < 0, dim=1, keepdim=True)
            st["collision"] = st["collision"] + collision_flag
            st["collision_wall"] = st["collision_wall"] + coll_wall.mean(-1, keepdim=True)
            st["collision_reward"] = (st["collision_reward"]
                                      + collision_reward.mean(-1, keepdim=True))

            # smoothness (deploy stage)
            smoothness_coef = torch.clamp(
                cfg.init_smoothness_coef + cfg.smooth_lr * state.update_epoch,
                max=cfg.max_smoothness_coef,
            )
            st["smoothness_coef"] = (smoothness_coef.expand(e, 1)
                                     * torch.ones_like(st["smoothness_coef"]))
            smoothness_reward = smoothness_coef * torch.exp(-res.action_error)
            if not cfg.use_deployment:
                smoothness_reward = torch.zeros_like(smoothness_reward)
            st["smoothness_reward"] = (st["smoothness_reward"]
                                       + smoothness_reward.mean(-1, keepdim=True))
            st["smoothness_mean"] = st["smoothness_mean"] + throttle_diff.mean(-1, keepdim=True)
            st["smoothness_max"] = torch.maximum(
                st["smoothness_max"], throttle_diff.max(-1, keepdim=True).values
            )

            reward = (distance_reward + detect_reward + catch_reward + collision_reward
                      + speed_reward + smoothness_reward)  # [E, n]
            st["return"] = st["return"] + reward.mean(-1, keepdim=True)

            done_env = progress >= cfg.max_episode_length
            done = done_env[:, None]

            out = (torch.square(target_pos[..., 0]) + torch.square(target_pos[..., 1])
                   > cfg.arena_size**2)
            st["out_of_arena"] = torch.logical_or(st["out_of_arena"].bool(), out).float()

            # per-episode normalization at done
            ep_len = torch.clamp(progress.float(), min=1.0)[:, None]
            div = torch.where(done, ep_len, torch.ones_like(ep_len))
            for k in _EP_NORMALIZED:
                st[k] = st[k] / div

        with trace.span("env.tp_frame"):
            # TP bookkeeping: append the new frame to the history window
            mid = dataclasses.replace(mid, stats=st)
            frame = self._tp_frame(mid, broadcast_detect)
            mid.history = torch.cat([state.history[:, 1:], frame[:, None, :]], dim=1)

        return mid, {
            "done_env": done_env,
            "done": done,
            "reward": reward[..., None].expand(e, n, 1),
            "capture": capture_flag.float(),
            "ctbr": res.ctbr,
            "drone_state": drone.state_vector()[..., :13],
        }

    def _segment_b(self, tp_net, state: HideAndSeekState):
        """The step after the reset gate, from the state it leaves: the TP
        prediction, the observation (detection included) and the TP
        targets.  (obs, critic state, prediction or None, tp_gt, tp_done)."""
        cfg = self.cfg
        pred = None
        if cfg.use_tp_net and tp_net is not None:
            with trace.span("env.tp_predict"):
                pred = self._tp_predict(tp_net, state.history)
        with trace.span("env.observe"):
            obs, critic_state = self.observe_full(state, tp_net, pred=pred)
            tp_gt = normalize_groundtruth(state.target_pos[:, 0], cfg.arena_size,
                                          cfg.max_height)
            tp_done = (state.progress
                       <= cfg.max_episode_length - cfg.future_prediction_step)[:, None]
        return obs, critic_state, pred, tp_gt, tp_done.float()
