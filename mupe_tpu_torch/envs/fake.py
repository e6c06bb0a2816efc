"""Sim-free env: run a policy with no physics (counterpart of
mupe_tpu/envs/fake.py; reference scripts/fake/fake_env.py).

`FakeHideAndSeek` has HideAndSeek's observation and action layout but a step
that only runs the rate controller and recomputes the observation: the
positions stay frozen unless `inject` writes externally measured ones (a
motion-capture system's), and the CTBR commands are read back from the
transition's info.  Progress wraps at `max_episode_length` with no scene
reset.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..transforms.ctbr import pid_rate_transform
from .base import Transition, register_env
from .hideandseek import HideAndSeek, HideAndSeekState


@register_env("FakeHideAndSeek")
class FakeHideAndSeek(HideAndSeek):
    """HideAndSeek with the physics step removed."""

    @torch.no_grad()
    def step(
        self,
        state: HideAndSeekState,
        action: torch.Tensor,
        gen: Optional[torch.Generator] = None,
        tp_net=None,
    ) -> Tuple[HideAndSeekState, Transition]:
        cfg = self.cfg
        e, n = cfg.num_envs, cfg.num_agents
        res = pid_rate_transform(self.params, state.drone, action, state.prev_action, state.pid,
                                 cfg.dt)
        progress = state.progress + 1
        new_state = dataclasses.replace(
            state, pid=res.pid_state, prev_action=res.ctbr_action,
            progress=torch.where(progress >= cfg.max_episode_length,
                                 torch.zeros_like(progress), progress),
        )
        frame = self._tp_frame(new_state)
        new_state.history = torch.cat([state.history[:, 1:], frame[:, None, :]], dim=1)
        obs, critic_state = self.observe_full(new_state, tp_net)
        dev = self.device
        info = {
            "drone_state": new_state.drone.state_vector()[..., :13],
            "ctbr": res.ctbr,
            "rotor_cmds": res.rotor_cmds,
            "prev_action": new_state.prev_action,
            "state": critic_state,
            "tp_input": new_state.history,
            "tp_gt": torch.zeros((e, 3), device=dev),
            "tp_done": torch.zeros((e, 1), device=dev),
        }
        return new_state, Transition(
            obs=obs,
            reward=torch.zeros((e, n, 1), device=dev),
            done=(progress >= cfg.max_episode_length)[:, None],
            stats=new_state.stats,
            info=info,
        )

    def inject(
        self,
        state: HideAndSeekState,
        drone_pos: torch.Tensor,
        drone_quat: torch.Tensor,
        drone_vel: torch.Tensor,
        drone_angvel: torch.Tensor,
        target_pos: torch.Tensor,
        target_vel: torch.Tensor,
    ) -> HideAndSeekState:
        """Overwrite the kinematic state with externally measured values."""
        return dataclasses.replace(
            state,
            drone=dataclasses.replace(state.drone, pos=drone_pos, quat=drone_quat,
                                      vel=drone_vel, angvel=drone_angvel),
            target_pos=target_pos,
            target_vel=target_vel,
        )
