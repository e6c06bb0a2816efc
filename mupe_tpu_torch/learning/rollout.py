"""Rollout: the policy acting in the arenas
(counterpart of `init_carry` and `rollout_prog` in mupe_tpu/learning/rollout.py).

Each step runs `policy.act` (actor + critic, one encoder kernel launch) and
`env.step` (which runs the TP-LSTM kernel for the next observation).  The
trajectory is returned time-major, as the JAX package's `rollout_prog`
returns it; `make_train_iter` feeds it to `MAPPOPolicy.train_op`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .mappo import MAPPOPolicy, MAPPOState


@dataclasses.dataclass
class IterCarry:
    """Carried across rollouts (all on the env's device)."""

    ts: MAPPOState
    env_state: Any
    obs: Dict[str, torch.Tensor]
    state: Any  # centralized-critic input (the env's critic_state)
    generator: torch.Generator


def init_carry(
    env,
    policy: MAPPOPolicy,
    generator: torch.Generator,
    ts: Optional[MAPPOState] = None,
    env_state=None,
) -> IterCarry:
    """Reset the env and build the initial carry.

    `generator` lives on the env's device and drives the env resets and the
    action noise.  Parameters not given as `ts` are initialised from a CPU
    generator seeded from it.  TP parameters come first because the TP
    prediction is part of the observation."""
    if ts is None:
        seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                 device=generator.device).item())
        template = {k: torch.zeros((1,) + shape) for k, shape in env.obs_groups().items()}
        ts = policy.init(template, torch.Generator().manual_seed(seed))
    if env_state is None:
        env_state = env.reset(generator)
    obs, state = env.observe_full(env_state, ts.tp_net)
    return IterCarry(ts=ts, env_state=env_state, obs=obs, state=state, generator=generator)


def make_rollout(
    env, policy: MAPPOPolicy, deterministic: bool = False
) -> Callable[..., Tuple[IterCarry, Dict[str, Any], Dict[str, torch.Tensor]]]:
    """Build `rollout(carry, steps=cfg.train_every) -> (carry, traj, ep_stats)`.

    traj holds [T, E, ...] tensors: value, reward, done, obs (dict), action,
    logp, and with the TP net tp_input, tp_gt, tp_done.  ep_stats is the
    mean of every stat over the transitions that ended an episode, plus
    episode_count."""
    uses_tp = policy.cfg.use_tp_net and getattr(env, "provides_tp", False)

    @torch.no_grad()
    def rollout(carry: IterCarry, steps: Optional[int] = None):
        steps = policy.cfg.train_every if steps is None else steps
        ts, env_state, obs = carry.ts, carry.env_state, carry.obs
        gen = carry.generator
        tp_net = ts.tp_net if uses_tp else None
        cols: Dict[str, list] = {k: [] for k in ("value", "reward", "done", "action", "logp")}
        cols["obs"] = []
        if uses_tp:
            cols.update(tp_input=[], tp_gt=[], tp_done=[])
        stat_keys = None
        stat_sums = n_done = 0.0
        for _ in range(steps):
            action, logp, value = policy.act(ts, obs, gen, deterministic=deterministic)
            env_state, tr = env.step(env_state, action, gen, tp_net)
            cols["obs"].append(obs)
            cols["action"].append(action)
            cols["logp"].append(logp)
            cols["value"].append(value)
            cols["reward"].append(tr.reward)
            cols["done"].append(tr.done)
            if uses_tp:
                cols["tp_input"].append(tr.info["tp_input"])
                cols["tp_gt"].append(tr.info["tp_gt"])
                cols["tp_done"].append(tr.info["tp_done"])
            # episode stats: sums over the transitions that ended an episode
            done = tr.done.float()                                  # [E, 1]
            stat_keys = list(tr.stats)
            stats = torch.cat([tr.stats[k] for k in stat_keys], dim=1)  # [E, K]
            stat_sums = stat_sums + torch.sum(stats * done, dim=0)
            n_done = n_done + torch.sum(done)
            obs = tr.obs
            last_state = tr.info["state"]
        traj = {k: torch.stack(v) for k, v in cols.items() if k != "obs"}
        traj["obs"] = {k: torch.stack([o[k] for o in cols["obs"]]) for k in cols["obs"][0]}
        denom = torch.clamp(n_done, min=1.0)
        ep_stats = dict(zip(stat_keys, (stat_sums / denom).unbind()))
        ep_stats["episode_count"] = n_done
        new_carry = dataclasses.replace(
            carry, env_state=env_state, obs=obs, state=last_state
        )
        return new_carry, traj, ep_stats

    return rollout


def make_train_iter(
    env, policy: MAPPOPolicy, deterministic: bool = False
) -> Callable[..., Tuple[IterCarry, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]:
    """Build `train_iter(carry, perms=None) -> (carry, metrics, ep_stats)`:
    one rollout of `train_every` steps, then `policy.train_op` on it (the
    counterpart of both `make_train_iter` and `make_split_train_iter` of
    mupe_tpu/learning/rollout.py; PyTorch runs eagerly, so the two are one).
    The carry's parameters are updated in place.  `perms` ([ppo_epochs,
    T*E]) fixes the minibatch draws; otherwise they come from the carry's
    generator.  `mark` is called with "rollout", then as `train_op` calls it."""
    rollout = make_rollout(env, policy, deterministic=deterministic)

    def train_iter(carry: IterCarry, perms: Optional[torch.Tensor] = None,
                   mark: Optional[Callable[[str], None]] = None):
        carry, traj, ep_stats = rollout(carry)
        if mark is not None:
            mark("rollout")
        ts, metrics = policy.train_op(carry.ts, traj, carry.obs, carry.generator, perms, mark)
        return dataclasses.replace(carry, ts=ts), metrics, ep_stats

    return train_iter
