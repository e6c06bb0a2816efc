"""What the benchmark hands the program and reads back from it.

The program is mupe_tpu_torch: its `harness.build` makes the env and the
policy of a configuration, `policy.init` takes the parameters that the
benchmark makes from the seed (on the device, in one draw), and the
drivers call `init_carry` / `make_train_iter` / `_make_eval_prog` as the
port's own training loop and evaluation do.  The same seed gives the
reference the same parameters (`reference_learner`).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional

import torch

from .reference import nets
from .reference.update import Learner

# MAPPOCfg's fields that the reference update reads
ALGO_KEYS = ("num_minibatches", "ppo_epochs", "clip_param", "entropy_coef", "gamma", "gae_lambda",
             "actor_lr", "critic_lr", "tp_lr", "max_grad_norm", "value_norm_beta", "huber_delta",
             "future_prediction_step")


@dataclasses.dataclass
class Layout:
    """The parameter layouts of a configuration's networks."""

    groups: Optional[tuple]        # entity groups in order, or None (flat)
    names: Optional[list]
    obs_dim: int
    n_agents: int
    action_dim: int
    hidden: tuple
    tp: Optional[tuple]            # (input_dim, out_dim) of the TP net

    def tables(self) -> Dict[str, list]:
        """(name, shape, kind) of each network's leaves (`nets`' tables)."""
        if self.groups is not None:
            a, c = (nets.encoder_table(self.groups, h, self.names) for h in (self.action_dim, 1))
        else:
            a, c = (nets.flat_table(self.obs_dim, self.hidden, h) for h in (self.action_dim, 1))
        return {"actor": a, "critic": c, "tp": nets.tp_table(*self.tp) if self.tp is not None
                else []}

    def actor(self):
        return nets.unnamed(self.tables()["actor"])

    def critic(self):
        return nets.unnamed(self.tables()["critic"])

    def tp_layout(self):
        return nets.unnamed(self.tables()["tp"])

    def leaf_names(self) -> List[str]:
        """`<group>.<leaf>` of each leaf in the order of the training
        check's norms: the actor's leaves and log_std, the critic's, the
        TP net's."""
        t = self.tables()
        return ([f"actor.{n}" for n, _, _ in t["actor"]] + ["actor.log_std"]
                + [f"critic.{n}" for n, _, _ in t["critic"]] + [f"tp.{n}" for n, _, _ in t["tp"]])


def layout_of(env, policy) -> Layout:
    cfg = policy.cfg
    tp = None
    if cfg.use_tp_net and getattr(env, "provides_tp", False):
        tp = (env.cfg.tp_input_dim, 3 * cfg.future_prediction_step)
    if policy.obs_is_dict:
        groups_d = env.obs_groups()
        names = nets.group_order(groups_d.keys())
        groups = tuple(tuple(groups_d[k]) for k in names)
        return Layout(groups, names, sum(k * d for k, d in groups), env.num_agents,
                      policy.action_dim, tuple(cfg.hidden_units), tp)
    return Layout(None, None, env.cfg.obs_dim, env.num_agents, policy.action_dim,
                  tuple(cfg.hidden_units), tp)


def draw_parameters(layout: Layout, gen: torch.Generator, device) -> Dict[str, Any]:
    """Every parameter from one standard-normal draw on `device`: the
    actor's, log_std, the critic's, the TP net's."""
    lays = [layout.actor(), [((layout.action_dim,), "b")], layout.critic(), layout.tp_layout()]
    sizes = [nets.layout_size(l) for l in lays]
    z = torch.randn(sum(sizes), generator=gen, device=device)
    parts = torch.split(z, sizes)
    actor = nets.make_leaves(lays[0], parts[0])
    log_std = -0.5 + parts[1]
    critic = nets.make_leaves(lays[2], parts[2])
    tp = nets.make_leaves(lays[3], parts[3]) if layout.tp is not None else None
    return {"actor": actor, "log_std": log_std, "critic": critic, "tp": tp}


def obs_example(env, policy, device):
    """Zeros of one arena's observation, the shapes `policy.init` reads."""
    if policy.obs_is_dict:
        return {k: torch.zeros((1, env.num_agents) + tuple(s), device=device)
                for k, s in env.obs_groups().items()}
    return torch.zeros((1, env.num_agents, env.cfg.obs_dim), device=device)


def init_state(env, policy, params):
    """The program's learner state over the benchmark's parameters."""
    return policy.init(obs_example(env, policy, params["log_std"].device),
                       actor_leaves=params["actor"], log_std=params["log_std"],
                       critic_leaves=params["critic"], tp_leaves=params["tp"])


def rounding(algo_cfg) -> str:
    """The configuration's precision: its networks' compute dtype."""
    return {"bfloat16": "bf16", "float32": "exact"}[algo_cfg.compute_dtype]


def reference_learner(layout: Layout, params, algo_cfg, rnd) -> Learner:
    cfg = {k: getattr(algo_cfg, k) for k in ALGO_KEYS}
    clone = lambda ls: None if ls is None else [l.detach().clone() for l in ls]  # noqa: E731
    return Learner(actor=clone(params["actor"]), log_std=params["log_std"].detach().clone(),
                   critic=clone(params["critic"]), tp=clone(params["tp"]), cfg=cfg,
                   groups=layout.groups, names=layout.names,
                   hidden=None if layout.groups is not None else layout.hidden, rnd=rnd)


def program_leaves(ts, layout: Layout) -> Dict[str, List[torch.Tensor]]:
    """The program's parameters split into the layout's leaves (the
    networks' flat vectors hold them in that order)."""
    def split(flat, lay):
        sizes = [nets.layout_size([l]) for l in lay]
        return [p.reshape(s) for p, (s, _) in zip(torch.split(flat.detach(), sizes), lay)]

    out = {"actor": split(ts.actor.flat, layout.actor()), "log_std": [ts.log_std.detach()],
           "critic": split(ts.critic.flat, layout.critic())}
    if ts.tp_net is not None:
        out["tp"] = [l.detach() for l in ts.tp_net.leaves()]
    return out


def tree_clone(x, device=None):
    """A deep copy of a tensor, a dict, a list or a dataclass of them
    (optionally moved to `device`)."""
    if isinstance(x, torch.Tensor):
        y = x.detach().clone()
        return y if device is None else y.to(device)
    if isinstance(x, dict):
        return {k: tree_clone(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(tree_clone(v, device) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: tree_clone(getattr(x, f.name), device)
                                         for f in dataclasses.fields(x)})
    return copy.copy(x)


def to_reference(x, classes: Dict[str, type]):
    """The program's env state as the reference's: each dataclass becomes
    the reference's class of the same name, field by field."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: to_reference(v, classes) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_reference(v, classes) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = classes[type(x).__name__]
        return cls(**{f.name: to_reference(getattr(x, f.name), classes)
                      for f in dataclasses.fields(x)})
    return x


def reference_classes() -> Dict[str, type]:
    """The reference's state classes by name."""
    from .reference.sim.controllers.pid_rate import PIDRateState
    from .reference.sim.dynamics.params import QuadrotorParams
    from .reference.sim.dynamics.quadrotor import DroneState
    from .reference.sim.envs.hideandseek import HideAndSeekState
    from .reference.sim.envs.hover import HoverState

    return {c.__name__: c for c in (PIDRateState, QuadrotorParams, DroneState, HideAndSeekState,
                                    HoverState)}


def reference_env(task: str, env_cfg, device):
    """The reference's env of the program's configuration (same fields)."""
    from .reference.sim.envs import ENVS

    cls = ENVS[task]
    cfg_cls = cls.cfg_cls
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    cfg = cfg_cls(**{k: v for k, v in dataclasses.asdict(env_cfg).items() if k in fields})
    return cls(cfg, device=device)


def generator_like(state: torch.Tensor, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.set_state(state)
    return g
