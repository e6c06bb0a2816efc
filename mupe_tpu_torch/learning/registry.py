"""Algorithm registry: configuration-driven policy construction
(counterpart of mupe_tpu/learning/registry.py).

Each factory takes the built env, the `algo.*` override dict and the
device, and returns a policy whose `init` / `act` / `train_op` the rollout
drives.  What each algorithm needs of the env's observation:

  mappo        any (flat or entity-dict observations; the TP net where the
               env provides its input)
  ppo          flat, or a dict with "intrinsics" when the privileged
               branches are on (Hover with env.dr_* ranges)
  ppo_adapt    a dict with "observation", "intrinsics" and "observation_h"
               (Hover with env.dr_* ranges and env.obs_history_len > 0;
               `harness.train_rma` trains its three phases)
  ppo_rnn      flat (recurrent: the rollout threads the hidden states)
  ppo_tconv    a dict with "observation_h" (env.obs_history_len > 0)
  ppo_sdf      a dict with "sdf_points" (no env of the repo emits them)
  transformer  entity dicts (a token per entity)
  ppo_vision   a dict with a "depth" frame [..., H, W, C] beside flat
               branches (Hover with env.obs_depth=true); `vision_encoder`
               (conv, mobilenet_v3_small, mobilenet_v3_large) is popped from
               the overrides before the cfg is built
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict

from ..utils.config import apply_overrides
from .mappo import MAPPOCfg, MAPPOPolicy
from .modules.networks import VisionNet
from .ppo import (
    PPOAdaptCfg,
    PPOAdaptivePolicy,
    PPOCfg,
    PPOPolicy,
    PPORNNCfg,
    PPORNNPolicy,
    PPOSDFNavPolicy,
    PPOTConvPolicy,
    TransformerPPOPolicy,
)

ALGOS: Dict[str, Callable] = {}


def register_algo(name: str):
    def deco(fn):
        ALGOS[name] = fn
        return fn

    return deco


def _mk_cfg(cfg_cls, env, overrides: Dict[str, Any]):
    """An algorithm's cfg with the env's TP-net settings threaded in first,
    so the overrides still win."""
    cfg = cfg_cls()
    if getattr(env, "provides_tp", False):
        cfg = dataclasses.replace(
            cfg, use_tp_net=env.cfg.use_tp_net,
            future_prediction_step=env.cfg.future_prediction_step,
            window_step=env.cfg.window_step)
    return apply_overrides(cfg, overrides or {})


def _obs_is_dict(env) -> bool:
    return getattr(env, "provides_tp", False) or bool(getattr(env.cfg, "obs_is_dict", False))


@register_algo("mappo")
def _make_mappo(env, overrides, device):
    cfg = _mk_cfg(MAPPOCfg, env, overrides)
    provides_tp = getattr(env, "provides_tp", False)
    return MAPPOPolicy(
        cfg, n_agents=env.num_agents, action_dim=env.action_dim, obs_is_dict=_obs_is_dict(env),
        tp_input_dim=env.cfg.tp_input_dim if provides_tp else None, device=device,
        tp_history_step=getattr(env.cfg, "history_step", 10))


@register_algo("ppo")
def _make_ppo(env, overrides, device):
    return PPOPolicy(_mk_cfg(PPOCfg, env, overrides), n_agents=env.num_agents,
                     action_dim=env.action_dim, obs_is_dict=_obs_is_dict(env), device=device)


@register_algo("ppo_adapt")
def _make_ppo_adapt(env, overrides, device):
    cfg = _mk_cfg(PPOAdaptCfg, env, overrides)
    if not _obs_is_dict(env):
        raise ValueError(
            "ppo_adapt needs dict observations with 'intrinsics' and 'observation_h' — enable "
            "env.dr_* ranges and env.obs_history_len (see envs/hover.py HoverCfg)")
    return PPOAdaptivePolicy(cfg, n_agents=env.num_agents, action_dim=env.action_dim,
                             device=device)


@register_algo("ppo_rnn")
def _make_ppo_rnn(env, overrides, device):
    return PPORNNPolicy(_mk_cfg(PPORNNCfg, env, overrides), n_agents=env.num_agents,
                        action_dim=env.action_dim, device=device)


@register_algo("ppo_tconv")
def _make_ppo_tconv(env, overrides, device):
    cfg = dataclasses.replace(_mk_cfg(MAPPOCfg, env, overrides), use_tp_net=False)
    return PPOTConvPolicy(cfg, n_agents=env.num_agents, action_dim=env.action_dim,
                          obs_is_dict=_obs_is_dict(env), device=device)


@register_algo("ppo_sdf")
def _make_ppo_sdf(env, overrides, device):
    cfg = dataclasses.replace(_mk_cfg(MAPPOCfg, env, overrides), use_tp_net=False)
    return PPOSDFNavPolicy(cfg, n_agents=env.num_agents, action_dim=env.action_dim,
                           device=device)


@register_algo("ppo_vision")
def _make_ppo_vision(env, overrides, device):
    """`VisionNet` actor and critic (`MixedObsEncoder`: the backbone on the
    depth frame, an MLP on each flat branch) in MAPPO's non-joint update."""
    overrides = dict(overrides)
    vision_encoder = overrides.pop("vision_encoder", "conv")
    cfg = dataclasses.replace(_mk_cfg(MAPPOCfg, env, overrides), use_tp_net=False)
    if not _obs_is_dict(env):
        raise ValueError(
            "ppo_vision needs dict observations with a 'depth' frame — set env.obs_depth=true "
            "(see envs/hover.py HoverCfg)")
    net = functools.partial(VisionNet, vision_encoder=vision_encoder)
    return MAPPOPolicy(cfg, n_agents=env.num_agents, action_dim=env.action_dim, obs_is_dict=True,
                       device=device,
                       actor_module=functools.partial(net, out_dim=env.action_dim, role="actor"),
                       critic_module=functools.partial(net, out_dim=1, role="critic"))


@register_algo("transformer")
def _make_transformer(env, overrides, device):
    cfg = dataclasses.replace(_mk_cfg(MAPPOCfg, env, overrides), use_tp_net=False)
    # HideAndSeek's envs emit per-agent entity dicts ([E, n, k, d])
    return TransformerPPOPolicy(cfg, n_agents=env.num_agents, action_dim=env.action_dim,
                                per_agent_obs=getattr(env, "provides_tp", False), device=device)


def make_policy(algo: str, env, overrides: Dict[str, Any] | None = None, device="cuda"):
    """Look up and build; an unknown name raises KeyError."""
    name = algo.lower()
    if name not in ALGOS:
        raise KeyError(f"unknown algo {algo!r}; available: {sorted(ALGOS)}")
    return ALGOS[name](env, overrides or {}, device)


def is_recurrent(policy) -> bool:
    """Recurrent policies thread hidden state through the rollout."""
    return isinstance(policy, PPORNNPolicy)
