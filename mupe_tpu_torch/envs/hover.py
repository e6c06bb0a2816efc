"""Hover: one drone stabilizes at a fixed point with a fixed heading.

Counterpart of mupe_tpu/envs/hover.py (reference
omni_drones/envs/single/hover.py): the same observation layout, reward
terms, CTBR telemetry stats and randomized initial pose, with the sim2real
options (multiplicative action and observation noise, a 2-step observation
latency, a point-mass payload), domain randomization of the dynamics
(`dr_*` ranges, with the privileged `intrinsics` branch), the sliding
observation-history window and the onboard depth camera (`obs_depth`: a
ray-cast frame of the ground and the target sphere).

Randomness comes from an explicit `torch.Generator` on the env's device;
every draw goes through `_uniform` / `_normal`, which the parity tests
replace to inject the JAX package's draws.  Episodes are synchronized (every
env resets at `max_episode_length`), so a step reads `done` on the host once
and draws the fresh per-env state only on the reset step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..controllers import PIDRateState
from ..core import euler_to_quaternion
from ..dynamics import DroneState, RigidBodyCfg, hover_state, make_params
from ..dynamics import step as dynamics_step
from ..dynamics.randomization import RandomizationCfg, intrinsics_vector, randomize_params
from ..parallel import dist
from ..transforms.ctbr import hover_prev_action_init, pid_rate_transform
from ..sensors.depth import DepthCameraCfg, depth_image, pinhole_rays
from ..transforms.obs import depth_image_norm, history_init, history_push
from ..utils import trace
from .base import Transition, register_env, where_done


@dataclasses.dataclass(frozen=True)
class HoverCfg:
    """Task hyper-parameters; the fields and defaults of the JAX package's
    HoverCfg (reference cfg/task/Hover.yaml)."""

    num_envs: int = 4096
    max_episode_length: int = 500
    dt: float = 0.01
    drone_model: str = "crazyflie"
    reward_distance_scale: float = 10.0
    reward_v_scale: float = 0.0
    reward_acc_scale: float = 0.0
    reward_jerk_scale: float = 0.0
    linear_vel_max: float = 3.0
    linear_acc_max: float = 10.0
    time_encoding_dim: int = 4
    action_noise: bool = False
    obs_noise: bool = False
    latency: bool = False
    payload: bool = False
    payload_z_range: Tuple[float, float] = (-0.1, 0.1)
    payload_mass_range: Tuple[float, float] = (0.01, 0.1)  # x drone mass
    obs_omega: bool = False
    obs_motor: bool = False
    # CLI syntax: env.dr_mass_scale='[0.8,1.2]'
    dr_mass_scale: Optional[Tuple[float, float]] = None
    dr_inertia_scale: Optional[Tuple[float, float]] = None
    dr_t2w_scale: Optional[Tuple[float, float]] = None
    dr_f2m_scale: Optional[Tuple[float, float]] = None
    dr_drag_scale: Optional[Tuple[float, float]] = None
    dr_rotor_offset_scale: Optional[Tuple[float, float]] = None
    dr_tau_up: Optional[Tuple[float, float]] = None
    dr_tau_down: Optional[Tuple[float, float]] = None
    obs_history_len: int = 0
    # onboard depth camera observation ("depth", [E, 1, H, W, 1] in [0, 1])
    obs_depth: bool = False
    depth_width: int = 32
    depth_height: int = 24
    depth_max_range: float = 8.0

    @property
    def use_dr(self) -> bool:
        return any(getattr(self, f) is not None for f in (
            "dr_mass_scale", "dr_inertia_scale", "dr_t2w_scale", "dr_f2m_scale",
            "dr_drag_scale", "dr_rotor_offset_scale", "dr_tau_up", "dr_tau_down"))

    @property
    def rand_cfg(self) -> RandomizationCfg:
        return RandomizationCfg(
            mass_scale=self.dr_mass_scale, inertia_scale=self.dr_inertia_scale,
            t2w_scale=self.dr_t2w_scale, f2m_scale=self.dr_f2m_scale,
            drag_coef_scale=self.dr_drag_scale, rotor_offset_scale=self.dr_rotor_offset_scale,
            tau_up=self.dr_tau_up, tau_down=self.dr_tau_down,
        )

    @property
    def obs_is_dict(self) -> bool:
        return self.use_dr or self.obs_history_len > 0 or self.obs_depth

    @property
    def latency_steps(self) -> int:
        return 2 if self.latency else 0

    @property
    def obs_dim(self) -> int:
        # rpos 3 + quat, vel 7 + heading, up 6 [+ omega 3] [+ motor 4] + time
        return (3 + 7 + 6 + (3 if self.obs_omega else 0) + (4 if self.obs_motor else 0)
                + self.time_encoding_dim)


STAT_KEYS = (
    "return", "pos_error", "heading_alignment", "uprightness", "action_smoothness",
    "episode_len", "reward_pos", "pos_bonus", "head_bonus",
    "linear_v_max", "angular_v_max", "linear_a_max", "angular_a_max",
    "linear_jerk_max", "angular_jerk_max",
    "linear_v_mean", "angular_v_mean", "linear_a_mean", "angular_a_mean",
    "linear_jerk_mean", "angular_jerk_mean", "action_error_order1_mean",
    # CTBR telemetry: commanded and realized body rates [deg/s] and the raw
    # motor-channel actions, overwritten every step
    "target_r_rate", "target_p_rate", "target_y_rate",
    "real_r_rate", "real_p_rate", "real_y_rate",
    "motor1", "motor2", "motor3", "motor4",
)
_SMOOTHNESS = ("linear_v", "angular_v", "linear_a", "angular_a", "linear_jerk", "angular_jerk")


@dataclasses.dataclass
class HoverState:
    drone: DroneState              # [E, 1, .]
    pid: PIDRateState              # [E, 1, .]
    prev_action: torch.Tensor      # [E, 1, 4]
    target_pos: torch.Tensor       # [E, 1, 3]
    target_heading: torch.Tensor   # [E, 1, 3]
    progress: torch.Tensor         # [E] int32
    stats: Dict[str, torch.Tensor]  # each [E, 1]
    last_linear_v: torch.Tensor    # [E, 1] smoothness trackers
    last_angular_v: torch.Tensor
    last_linear_a: torch.Tensor
    last_angular_a: torch.Tensor
    payload_mass: torch.Tensor     # [E, 1, 1] kg (zeros without payload)
    payload_z: torch.Tensor        # [E, 1, 1] body-frame z offset
    obs_buf: torch.Tensor          # [E, L, 1, obs_dim] latency ring, oldest first
    dyn_params: Any = None         # per-env QuadrotorParams (domain randomization)
    intrinsics: Any = None         # [E, 1, 6 + 4 R] (22 for 4 rotors)
    obs_h: Any = None              # [E, 1, H, obs_dim] history window


@register_env("Hover")
class Hover:
    """Vectorized hover env on one device; reset, observe and step run
    without autograd."""

    provides_tp = False
    cfg_cls = HoverCfg

    def __init__(self, cfg: HoverCfg = HoverCfg(), device: torch.device | str = "cuda",
                 shard: Optional[dist.EnvShard] = None):
        # `cfg` is the global configuration; the env holds `shard`'s arenas
        # (all of them by default) and `self.cfg.num_envs` counts those
        cfg, self.shard = dist.local_cfg(cfg, shard)
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = make_params(cfg.drone_model, self.device)
        self.rigid_cfg = RigidBodyCfg(max_linear_velocity=1000.0)
        self.num_agents = 1
        self.action_dim = 4
        self._target_pos = torch.tensor([0.0, 0.0, 1.0], device=self.device)
        self._target_heading = torch.tensor([1.0, 0.0, 0.0], device=self.device)
        self._no_z = torch.tensor([1.0, 1.0, 0.0], device=self.device)
        self._rays = torch.from_numpy(pinhole_rays(DepthCameraCfg(
            width=cfg.depth_width, height=cfg.depth_height))).to(self.device)

    @property
    def num_envs(self) -> int:
        return self.cfg.num_envs

    # ------------------------------------------------------------- draws
    def _uniform(self, gen, shape, lo, hi) -> torch.Tensor:
        """U(lo, hi) of `shape`; every uniform draw goes through here (at
        the global arena count, this shard's rows kept)."""
        lo = torch.as_tensor(lo, dtype=torch.float32, device=self.device)
        hi = torch.as_tensor(hi, dtype=torch.float32, device=self.device)
        return lo + (hi - lo) * self.shard.draw(
            lambda s: torch.rand(s, generator=gen, device=self.device), shape)

    def _normal(self, gen, shape) -> torch.Tensor:
        """Standard normal noise of `shape` (action and observation noise)."""
        return self.shard.draw(lambda s: torch.randn(s, generator=gen, device=self.device),
                               shape)

    # ------------------------------------------------------------- reset
    def _sample_dr(self, gen):
        """Per-env randomized parameters and the intrinsics vector, or
        (None, None) without domain randomization."""
        if not self.cfg.use_dr:
            return None, None
        params, intr = randomize_params(
            lambda shape, lo, hi: self._uniform(gen, shape, lo, hi),
            self.params, self.cfg.rand_cfg, self.cfg.num_envs)
        return params, intrinsics_vector(intr)

    def _sample_drone_state(self, gen, params=None) -> DroneState:
        """pos ~ U([-1, -1, 0.05], [1, 1, 2]), rpy ~ U(+-0.2 pi, yaw [0, 0.5
        pi]); the throttle is hover's under `params` (the randomized ones
        where given)."""
        batch = (self.cfg.num_envs, 1)
        pos = self._uniform(gen, batch + (3,), [-1.0, -1.0, 0.05], [1.0, 1.0, 2.0])
        rpy = self._uniform(gen, batch + (3,), [-0.2 * math.pi, -0.2 * math.pi, 0.0],
                            [0.2 * math.pi, 0.2 * math.pi, 0.5 * math.pi])
        return hover_state(params if params is not None else self.params, pos,
                           euler_to_quaternion(rpy))

    def _sample_payload(self, gen) -> Tuple[torch.Tensor, torch.Tensor]:
        """Payload mass (x drone mass) and body-frame z offset, [E, 1, 1]."""
        cfg = self.cfg
        shape = (cfg.num_envs, 1, 1)
        if not cfg.payload:
            z = torch.zeros(shape, device=self.device)
            return z, z
        mass = self.params.mass * self._uniform(gen, shape, *cfg.payload_mass_range)
        z = self._uniform(gen, shape, *cfg.payload_z_range)
        return mass, z

    def _zero_stats(self) -> Dict[str, torch.Tensor]:
        zeros = torch.zeros((self.cfg.num_envs, 1), device=self.device)
        return {k: zeros for k in STAT_KEYS}

    @torch.no_grad()
    def reset(self, gen: torch.Generator) -> HoverState:
        cfg = self.cfg
        e = cfg.num_envs
        dyn_params, intrinsics = self._sample_dr(gen)
        drone = self._sample_drone_state(gen, dyn_params)
        payload_mass, payload_z = self._sample_payload(gen)
        zeros1 = torch.zeros((e, 1), device=self.device)
        state = HoverState(
            drone=drone,
            pid=PIDRateState.zeros((e, 1), device=self.device),
            prev_action=hover_prev_action_init(self.params, drone.throttle),
            target_pos=self._target_pos.expand(e, 1, 3),
            target_heading=self._target_heading.expand(e, 1, 3),
            progress=torch.zeros((e,), dtype=torch.int32, device=self.device),
            stats=self._zero_stats(),
            last_linear_v=zeros1, last_angular_v=zeros1,
            last_linear_a=zeros1, last_angular_a=zeros1,
            payload_mass=payload_mass, payload_z=payload_z,
            obs_buf=torch.zeros((e, cfg.latency_steps, 1, cfg.obs_dim), device=self.device),
            dyn_params=dyn_params, intrinsics=intrinsics,
        )
        if cfg.latency:
            obs0 = self._observe_now(state)
            state.obs_buf = obs0[:, None].expand(e, cfg.latency_steps, 1, cfg.obs_dim).contiguous()
        if cfg.obs_history_len > 0:
            state.obs_h = history_init(self._flat_obs(state), cfg.obs_history_len)
        return state

    # ------------------------------------------------------------- observe
    def _observe_now(self, state: HoverState) -> torch.Tensor:
        """The instantaneous [rpos, quat, vel, heading, up, (omega),
        (motor), t] → [E, 1, obs_dim]."""
        cfg = self.cfg
        d = state.drone
        parts = [state.target_pos - d.pos, d.quat, d.vel, d.heading, d.up]
        if cfg.obs_omega:
            parts.append(d.angvel)
        if cfg.obs_motor:
            parts.append(d.throttle * 2.0 - 1.0)
        t = (state.progress / cfg.max_episode_length)[:, None, None]
        parts.append(t.expand(cfg.num_envs, 1, cfg.time_encoding_dim))
        return torch.cat(parts, dim=-1)

    def _flat_obs(self, state: HoverState) -> torch.Tensor:
        """The flat policy observation: the latency ring's head when the
        2-step delay is on."""
        if self.cfg.latency:
            return state.obs_buf[:, 0]
        return self._observe_now(state)

    def _dict_obs(self, state: HoverState, flat: torch.Tensor):
        obs = {"observation": flat}
        if self.cfg.use_dr:
            obs["intrinsics"] = state.intrinsics
        if self.cfg.obs_history_len > 0:
            obs["observation_h"] = state.obs_h
        if self.cfg.obs_depth:
            obs["depth"] = self._depth_obs(state)
        return obs

    def _depth_obs(self, state: HoverState) -> torch.Tensor:
        """The onboard depth frame [E, 1, H, W, 1] in [0, 1]: the ground and
        the target (a sphere of radius 0.25) ray-cast from the drone's pose,
        then `depth_image_norm`."""
        cam = DepthCameraCfg(width=self.cfg.depth_width, height=self.cfg.depth_height,
                             max_range=self.cfg.depth_max_range)
        d = state.drone
        with trace.span("env.depth"):
            depth = depth_image(cam, d.pos, d.quat, target_pos=state.target_pos,
                                target_radius=0.25, rays=self._rays)
            return depth_image_norm(depth, cam.min_range, cam.max_range)[..., None]

    @torch.no_grad()
    def observe(self, state: HoverState):
        """A flat [E, 1, obs_dim] tensor; a dict with the privileged
        `intrinsics` branch, the `observation_h` window and / or the `depth`
        frame when domain randomization, the history or the camera are on
        (the layouts ppo_adapt and ppo_vision consume)."""
        flat = self._flat_obs(state)
        return self._dict_obs(state, flat) if self.cfg.obs_is_dict else flat

    # ------------------------------------------------------------- step
    def _select_params(self, done_env: torch.Tensor, fresh, old):
        """Take the fresh per-env parameter leaves where done; the leaves
        that stay unbatched (directions) are kept."""
        e = self.cfg.num_envs

        def sel(a, b):
            if isinstance(a, torch.Tensor) and a.dim() >= 1 and a.shape[0] == e:
                return torch.where(done_env.reshape((e,) + (1,) * (a.dim() - 1)), a, b)
            return b

        return dataclasses.replace(old, **{
            f.name: sel(getattr(fresh, f.name), getattr(old, f.name))
            for f in dataclasses.fields(old)})

    @torch.no_grad()
    def step(
        self, state: HoverState, action: torch.Tensor, gen: Optional[torch.Generator] = None,
    ) -> Tuple[HoverState, Transition]:
        cfg = self.cfg
        params = self.params
        e = cfg.num_envs
        if params.num_rotors != 4:
            # the JAX package fails here too: the rate controller mixes onto
            # 4 motors, the dynamics want one command per rotor
            raise TypeError(
                f"Hover's CTBR rate controller mixes onto 4 motors; drone model "
                f"{cfg.drone_model!r} has {params.num_rotors} rotors")

        if cfg.action_noise:  # multiplicative (hover.py:339-340)
            action = action * (self._normal(gen, action.shape) * 0.1 + 1.0)

        # the rate controller runs on the NOMINAL parameters (the firmware does
        # not know the perturbed physics); the dynamics on the randomized ones
        # plus the payload's mass and parallel-axis inertia
        res = pid_rate_transform(params, state.drone, action, state.prev_action, state.pid, cfg.dt)
        base = state.dyn_params if cfg.use_dr else params
        if cfg.payload:
            mp = state.payload_mass[..., 0]                      # [E, 1]
            d_inertia = mp[..., None] * torch.square(state.payload_z) * self._no_z
            dyn_params = dataclasses.replace(base, mass=base.mass + mp,
                                             inertia=base.inertia + d_inertia)
        else:
            dyn_params = base
        drone, throttle_diff = dynamics_step(dyn_params, state.drone, res.rotor_cmds, cfg.dt,
                                             self.rigid_cfg, enable_downwash=False)
        progress = state.progress + 1

        # reward (hover.py:439-498)
        pos_error = torch.linalg.vector_norm(state.target_pos - drone.pos, dim=-1)
        head_error = torch.linalg.vector_norm(state.target_heading - drone.heading, dim=-1)
        heading_alignment = torch.sum(drone.heading * state.target_heading, dim=-1)
        reward_pos = -pos_error * cfg.reward_distance_scale
        pos_bonus = (pos_error <= 0.02).float() * 10.0
        at_pos = pos_bonus > 0
        reward_head = -head_error * at_pos
        head_bonus = (head_error <= 0.02).float() * 10.0 * at_pos
        reward_up = torch.square((drone.up[..., 2] + 1.0) * 0.5)

        cur = {"linear_v": torch.linalg.vector_norm(drone.vel, dim=-1),
               "angular_v": torch.linalg.vector_norm(drone.angvel, dim=-1)}
        cur["linear_a"] = torch.abs(cur["linear_v"] - state.last_linear_v) / cfg.dt
        cur["angular_a"] = torch.abs(cur["angular_v"] - state.last_angular_v) / cfg.dt
        cur["linear_jerk"] = torch.abs(cur["linear_a"] - state.last_linear_a) / cfg.dt
        cur["angular_jerk"] = torch.abs(cur["angular_a"] - state.last_angular_a) / cfg.dt

        reward_v = cfg.reward_v_scale * at_pos * (cur["linear_v"] < cfg.linear_vel_max)
        reward_acc = cfg.reward_acc_scale * at_pos * (cur["linear_a"] < cfg.linear_acc_max)
        reward_jerk = cfg.reward_jerk_scale * at_pos * (-cur["linear_jerk"])
        reward = (reward_pos + pos_bonus + reward_head + head_bonus + reward_up
                  + reward_v + reward_acc + reward_jerk)
        done_env = progress >= cfg.max_episode_length  # [E]
        done = done_env[:, None]

        # stats, EMA'd / maxed (hover.py:386-513)
        alpha = 0.8
        pcount = progress.float()[:, None]
        st = dict(state.stats)
        st["return"] = st["return"] + reward
        st["pos_error"] = st["pos_error"] + (1 - alpha) * (pos_error - st["pos_error"])
        st["heading_alignment"] = st["heading_alignment"] + (1 - alpha) * (
            heading_alignment - st["heading_alignment"])
        st["uprightness"] = st["uprightness"] + (1 - alpha) * (
            drone.up[..., 2] - st["uprightness"])
        st["action_smoothness"] = st["action_smoothness"] + (1 - alpha) * (
            -throttle_diff - st["action_smoothness"])
        st["episode_len"] = pcount * torch.ones_like(st["episode_len"])
        st["reward_pos"] = reward_pos
        st["pos_bonus"] = pos_bonus
        st["head_bonus"] = head_bonus
        for name in _SMOOTHNESS:
            a = torch.abs(cur[name])
            st[f"{name}_max"] = torch.maximum(st[f"{name}_max"], a)
            st[f"{name}_mean"] = st[f"{name}_mean"] + (a - st[f"{name}_mean"]) / pcount
        st["action_error_order1_mean"] = st["action_error_order1_mean"] + (
            res.action_error - st["action_error_order1_mean"]) / pcount
        body_rate_deg = drone.body_rate * (180.0 / math.pi)
        for i, ax in enumerate("rpy"):
            st[f"target_{ax}_rate"] = res.target_rate_deg[..., i]
            st[f"real_{ax}_rate"] = body_rate_deg[..., i]
        for i in range(4):
            st[f"motor{i + 1}"] = action[..., i]

        new_state = dataclasses.replace(
            state, drone=drone, pid=res.pid_state, prev_action=res.ctbr_action,
            progress=progress, stats=st,
            last_linear_v=cur["linear_v"], last_angular_v=cur["angular_v"],
            last_linear_a=cur["linear_a"], last_angular_a=cur["angular_a"],
        )
        # auto-reset: done envs get a fresh state (stats zeroed); the
        # transition keeps the finished episode's stats.  One host read: the
        # fresh state is drawn only on the (synchronized) reset step, and
        # with ranks on the flag of every rank's arenas (all draw alike).
        if dist.any_across(done_env):
            with trace.span("env.reset"):
                new_state = self._auto_reset(new_state, done_env, gen)

        inst_obs = self._observe_now(new_state)
        if cfg.obs_noise:  # multiplicative, before the latency ring (hover.py:423-428)
            inst_obs = inst_obs * (self._normal(gen, inst_obs.shape) * 0.1 + 1.0)
        if cfg.latency:
            new_state.obs_buf = torch.cat([state.obs_buf[:, 1:], inst_obs[:, None]], dim=1)
            obs = new_state.obs_buf[:, 0]
        else:
            obs = inst_obs
        if cfg.obs_history_len > 0:  # slide one frame; refill on reset
            new_state.obs_h = where_done(done_env, history_init(obs, cfg.obs_history_len),
                                         history_push(state.obs_h, obs))
        if cfg.obs_is_dict:
            obs = self._dict_obs(new_state, obs)

        info = {"drone_state": drone.state_vector()[..., :13], "ctbr": res.ctbr,
                "prev_action": new_state.prev_action}
        return new_state, Transition(obs=obs, reward=reward[..., None], done=done, stats=st,
                                     info=info)

    def _auto_reset(self, mid: HoverState, done_env: torch.Tensor, gen) -> HoverState:
        """The fresh per-env state where done, drawn in the JAX package's
        order: randomized parameters, pose, payload."""
        if gen is None:
            raise ValueError("an episode ended: step needs a generator to reset")
        cfg = self.cfg
        e = cfg.num_envs
        fresh_params, fresh_intr = self._sample_dr(gen)
        fresh_drone = self._sample_drone_state(gen, fresh_params)
        fresh_pm, fresh_pz = self._sample_payload(gen)
        zeros1 = torch.zeros((e, 1), device=self.device)

        def sel(a, b):
            return where_done(done_env, a, b)

        out = dataclasses.replace(
            mid,
            drone=sel(fresh_drone, mid.drone),
            pid=sel(PIDRateState.zeros((e, 1), device=self.device), mid.pid),
            prev_action=sel(hover_prev_action_init(self.params, fresh_drone.throttle),
                            mid.prev_action),
            progress=torch.where(done_env, torch.zeros_like(mid.progress), mid.progress),
            stats=sel(self._zero_stats(), mid.stats),
            last_linear_v=sel(zeros1, mid.last_linear_v),
            last_angular_v=sel(zeros1, mid.last_angular_v),
            last_linear_a=sel(zeros1, mid.last_linear_a),
            last_angular_a=sel(zeros1, mid.last_angular_a),
            payload_mass=sel(fresh_pm, mid.payload_mass),
            payload_z=sel(fresh_pz, mid.payload_z),
        )
        if cfg.use_dr:
            out.dyn_params = self._select_params(done_env, fresh_params, mid.dyn_params)
            out.intrinsics = sel(fresh_intr, mid.intrinsics)
        return out
