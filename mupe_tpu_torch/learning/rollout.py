"""Rollout: the policy acting in the arenas
(counterpart of `init_carry` and `rollout_prog` in mupe_tpu/learning/rollout.py).

Each step runs `policy.act` (actor + critic, one encoder kernel launch over
dict observations) and `env.step` (which, for an env that provides the TP
net's input, runs the TP-LSTM kernel for the next observation).  Envs
without it (Hover) step without the TP net and are observed through
`env.observe`, as the JAX package dispatches on `provides_tp`.  The
trajectory is returned time-major, as the JAX package's `rollout_prog`
returns it; `make_train_iter` feeds it to `MAPPOPolicy.train_op`.  With the
centralized critic (`critic_input="state"`) `act` reads the env's critic
state and the trajectory keeps it.

Recurrent policies (ppo_rnn) have their own carry, `RNNIterCarry`, and
iteration, `make_rnn_train_iter` (mupe_tpu/learning/rollout.py:261-376):
the GRU states and the `is_init` flags ride along, each step's pre-step
states are kept for the update's BPTT chunks, and `is_init` of the next
step is the step's `done`.
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
    obs: Any    # a dict of entity groups, or a flat [E, n, D] tensor
    state: Any  # centralized-critic input (the env's critic_state), or None
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
    prediction is part of the observation; an env without the TP input
    gives the parameters' shapes by its first observation.  The centralized
    critic (`critic_input="state"`) is built over the first critic state,
    so the TP net comes first there, then the reset and the observation
    (the order of the JAX package's `init_carry`)."""
    provides_tp = getattr(env, "provides_tp", False)
    by_state = policy.cfg.critic_input == "state"
    tp_net = None
    if ts is None:
        seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                 device=generator.device).item())
        init_gen = torch.Generator().manual_seed(seed)
        if provides_tp and by_state:
            tp_net = policy.init_tp(init_gen)
        elif provides_tp:
            ts = policy.init(obs_template(env), init_gen)
    if env_state is None:
        env_state = env.reset(generator)
    if provides_tp:
        obs, state = env.observe_full(env_state, ts.tp_net if ts is not None else tp_net)
    else:
        obs, state = env.observe(env_state), None
    if ts is None:
        ts = policy.init(obs, init_gen, state_example=state,
                         tp_leaves=None if tp_net is None else list(tp_net.leaves()))
    return IterCarry(ts=ts, env_state=env_state, obs=obs, state=state, generator=generator)


def obs_template(env) -> Dict[str, torch.Tensor]:
    """Zeros of one arena's observation, [1, n, k, d] a group."""
    return {k: torch.zeros((1, env.num_agents) + tuple(shape))
            for k, shape in env.obs_groups().items()}


def stack_steps(steps):
    """Per-step tensors or dicts of them → one [T, ...] tensor or dict."""
    if isinstance(steps[0], dict):
        return {k: stack_steps([s[k] for s in steps]) for k in steps[0]}
    return torch.stack(steps)


class EpisodeStats:
    """Every stat's mean over the transitions that ended an episode, and
    `episode_count` (the JAX package's done-masked sums), accumulated step
    by step in the first step's key order."""

    def __init__(self):
        self.keys, self.sums, self.n_done = None, 0.0, 0.0

    def add(self, tr) -> None:
        done = tr.done.float()                                          # [E, 1]
        self.keys = self.keys or list(tr.stats)
        stats = torch.cat([tr.stats[k] for k in self.keys], dim=1)      # [E, K]
        self.sums = self.sums + torch.sum(stats * done, dim=0)
        self.n_done = self.n_done + torch.sum(done)

    def result(self) -> Dict[str, torch.Tensor]:
        out = dict(zip(self.keys, (self.sums / torch.clamp(self.n_done, min=1.0)).unbind()))
        out["episode_count"] = self.n_done
        return out


def make_rollout(
    env, policy: MAPPOPolicy, deterministic: bool = False
) -> Callable[..., Tuple[IterCarry, Dict[str, Any], Dict[str, torch.Tensor]]]:
    """Build `rollout(carry, steps=cfg.train_every) -> (carry, traj, ep_stats)`.

    traj holds [T, E, ...] tensors: value, reward, done, obs (a dict, or a
    tensor for flat observations), action, logp, with the TP net
    tp_input, tp_gt, tp_done, and with the centralized critic state (the
    critic state each step acted on).  ep_stats is the
    mean of every stat over the transitions that ended an episode, plus
    episode_count."""
    provides_tp = getattr(env, "provides_tp", False)
    uses_tp = policy.cfg.use_tp_net and provides_tp
    by_state = policy.cfg.critic_input == "state"

    @torch.no_grad()
    def rollout(carry: IterCarry, steps: Optional[int] = None):
        steps = policy.cfg.train_every if steps is None else steps
        ts, env_state, obs, last_state = carry.ts, carry.env_state, carry.obs, carry.state
        gen = carry.generator
        tp_net = ts.tp_net if uses_tp else None
        cols: Dict[str, list] = {k: [] for k in ("value", "reward", "done", "action", "logp")}
        cols["obs"] = []
        if by_state:
            cols["state"] = []
        if uses_tp:
            cols.update(tp_input=[], tp_gt=[], tp_done=[])
        stats = EpisodeStats()
        step_args = (tp_net,) if provides_tp else ()
        for _ in range(steps):
            state_kw = {"state": last_state} if by_state else {}
            action, logp, value = policy.act(ts, obs, gen, deterministic=deterministic,
                                             **state_kw)
            env_state, tr = env.step(env_state, action, gen, *step_args)
            cols["obs"].append(obs)
            if by_state:
                cols["state"].append(last_state)
            cols["action"].append(action)
            cols["logp"].append(logp)
            cols["value"].append(value)
            cols["reward"].append(tr.reward)
            cols["done"].append(tr.done)
            if uses_tp:
                cols["tp_input"].append(tr.info["tp_input"])
                cols["tp_gt"].append(tr.info["tp_gt"])
                cols["tp_done"].append(tr.info["tp_done"])
            stats.add(tr)
            obs = tr.obs
            last_state = tr.info.get("state")
        traj = {k: stack_steps(v) for k, v in cols.items()}
        ep_stats = stats.result()
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
        ts, metrics = policy.train_op(carry.ts, traj, carry.obs, carry.generator, perms, mark,
                                      last_state=carry.state)
        return dataclasses.replace(carry, ts=ts), metrics, ep_stats

    return train_iter


@dataclasses.dataclass
class RNNIterCarry:
    """The recurrent policies' carry (ppo_rnn): the GRU states and the
    `is_init` flags ride along with the env state."""

    ts: Any
    env_state: Any
    obs: torch.Tensor         # [E, n, D]
    actor_rnn: torch.Tensor   # [E, n, H]
    critic_rnn: torch.Tensor  # [E, n, H]
    is_init: torch.Tensor     # [E, n, 1] bool
    generator: torch.Generator


def init_rnn_carry(env, policy, generator: torch.Generator, ts=None,
                   env_state=None) -> RNNIterCarry:
    """Reset the env and build the recurrent carry: hidden states zero,
    `is_init` set everywhere, so the masked GRU starts fresh.  Parameters
    not given as `ts` come from a CPU generator seeded from `generator`."""
    if ts is None:
        seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                 device=generator.device).item())
    if env_state is None:
        env_state = env.reset(generator)
    obs = env.observe(env_state)
    if ts is None:
        ts = policy.init(obs, torch.Generator().manual_seed(seed))
    h0 = policy.zero_state(obs.shape[:-1])
    return RNNIterCarry(ts=ts, env_state=env_state, obs=obs, actor_rnn=h0, critic_rnn=h0.clone(),
                        is_init=torch.ones(obs.shape[:-1] + (1,), dtype=torch.bool,
                                           device=obs.device),
                        generator=generator)


def make_rnn_rollout(env, policy, deterministic: bool = False):
    """Build `rollout(carry) -> (carry, batch, ep_stats)` for `PPORNNPolicy`
    (mupe_tpu/learning/rollout.py:274-306): `train_every` steps threading
    the GRU states; `batch` holds JAX's `RNNRollout` fields, each step's
    pre-step states and `is_init` among them, for the update's BPTT chunks;
    the next step's `is_init` is the step's `done`."""

    @torch.no_grad()
    def rollout(carry: RNNIterCarry):
        ts, env_state, obs, gen = carry.ts, carry.env_state, carry.obs, carry.generator
        a_rnn, c_rnn, is_init = carry.actor_rnn, carry.critic_rnn, carry.is_init
        cols: Dict[str, list] = {k: [] for k in ("obs", "action", "logp", "value", "reward",
                                                 "done", "is_init", "actor_rnn", "critic_rnn")}
        stats = EpisodeStats()
        for _ in range(policy.cfg.train_every):
            action, logp, value, new_a, new_c = policy.act(ts, obs, a_rnn, c_rnn, is_init, gen,
                                                           deterministic=deterministic)
            env_state, tr = env.step(env_state, action, gen)
            for k, v in (("obs", obs), ("action", action), ("logp", logp), ("value", value),
                         ("reward", tr.reward), ("done", tr.done), ("is_init", is_init),
                         ("actor_rnn", a_rnn), ("critic_rnn", c_rnn)):
                cols[k].append(v)
            stats.add(tr)
            obs, a_rnn, c_rnn = tr.obs, new_a, new_c
            is_init = tr.done[:, :, None].expand(is_init.shape).to(torch.bool)
        batch = {k: torch.stack(v) for k, v in cols.items()}
        batch.update(last_obs=obs, last_actor_rnn=a_rnn, last_critic_rnn=c_rnn,
                     last_is_init=is_init)
        new_carry = dataclasses.replace(carry, env_state=env_state, obs=obs, actor_rnn=a_rnn,
                                        critic_rnn=c_rnn, is_init=is_init)
        return new_carry, batch, stats.result()

    return rollout


def make_rnn_train_iter(env, policy, deterministic: bool = False):
    """Build `train_iter(carry, perms=None) -> (carry, metrics, ep_stats)`
    for `PPORNNPolicy`: `make_rnn_rollout`, then `policy.train_op`."""
    rollout = make_rnn_rollout(env, policy, deterministic)

    def train_iter(carry: RNNIterCarry, perms: Optional[torch.Tensor] = None,
                   mark: Optional[Callable[[str], None]] = None):
        carry, batch, ep_stats = rollout(carry)
        if mark is not None:
            mark("rollout")
        ts, metrics = policy.train_op(carry.ts, batch, carry.generator, perms)
        if mark is not None:
            mark("update")
        return dataclasses.replace(carry, ts=ts), metrics, ep_stats

    return train_iter
