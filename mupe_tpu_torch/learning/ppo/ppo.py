"""Single-agent PPO with optional privileged-intrinsics branches
(counterpart of mupe_tpu/learning/ppo/ppo.py).

`PPOPolicy` is `MAPPOPolicy` with injected networks: flat `MLP((256, 256,
256))` actor and critic over the observation (Hover's flat one, or the
`observation` branch of its dict), or with `priv_actor` / `priv_critic` the
privileged branch, `MLP((128, 128))` on the observation beside
`LayerNorm -> MLP((64, 64))` on the drone's `intrinsics` (the `dr_*`
ranges' parameters), concatenated into `MLP((256, 256))` (ppo.py:44-55).
The JAX family's `MLP`s take no dtype, so every network here runs in
float32 whatever `compute_dtype` says, and the flat actor has no input
LayerNorm (unlike MAPPO's `FlatEncoder`).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..mappo import MAPPOCfg, MAPPOPolicy
from ..modules.networks import HeadNet, _feat, apply_ln, apply_mlp, ln_leaves, mlp_leaves


@dataclasses.dataclass(frozen=True)
class PPOCfg(MAPPOCfg):
    """PPO defaults (reference ppo.py:42-55 and its constants :92-97)."""

    train_every: int = 32
    ppo_epochs: int = 4
    num_minibatches: int = 16
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_param: float = 0.1
    entropy_coef: float = 0.001
    huber_delta: float = 10.0
    priv_actor: bool = False
    priv_critic: bool = False
    use_tp_net: bool = False


_PRIV = "_PrivBranch_0"


class PrivNet(HeadNet):
    """The privileged branch (JAX `_PrivBranch`) and a head: `_PrivActor`
    / `_PrivCritic` over {"observation", "intrinsics"}."""

    def __init__(self, example, out_dim: int, role: str, leaves=None, generator=None):
        super().__init__()
        self._setup(example, out_dim, role, leaves, generator)

    def body_specs(self, obs):
        d_obs, d_intr = obs["observation"].shape[-1], obs["intrinsics"].shape[-1]
        return (mlp_leaves(f"{_PRIV}/MLP_0", d_obs, (128, 128))
                + ln_leaves(f"{_PRIV}/LayerNorm_0", d_intr)
                + mlp_leaves(f"{_PRIV}/MLP_1", d_intr, (64, 64))
                + mlp_leaves(f"{_PRIV}/MLP_2", 128 + 64, (256, 256))), 256

    def body(self, p, obs):
        feat = apply_mlp(p, f"{_PRIV}/MLP_0", obs["observation"], 2)
        ctx = apply_mlp(p, f"{_PRIV}/MLP_1", apply_ln(p, f"{_PRIV}/LayerNorm_0", obs["intrinsics"]),
                        2)
        return apply_mlp(p, f"{_PRIV}/MLP_2", torch.cat([feat, ctx], dim=-1), 2)


class FlatNet(HeadNet):
    """`MLP((256, 256, 256))` on the observation (or a dict's `observation`
    branch) and a head: JAX `_FlatActor` / `_FlatCritic`."""

    def __init__(self, example, out_dim: int, role: str, leaves=None, generator=None):
        super().__init__()
        self._setup(example, out_dim, role, leaves, generator)

    def body_specs(self, obs):
        return mlp_leaves("MLP_0", _feat(obs, "observation").shape[-1], (256, 256, 256)), 256

    def body(self, p, obs):
        return apply_mlp(p, "MLP_0", _feat(obs, "observation"), 3)


class PPOPolicy(MAPPOPolicy):
    """Single-agent PPO; observations are flat, or {"observation",
    "intrinsics"} dicts when the privileged branches are on."""

    def __init__(self, cfg: PPOCfg = PPOCfg(), n_agents: int = 1, action_dim: int = 4,
                 obs_is_dict: bool = False, device="cuda"):
        actor = PrivNet if cfg.priv_actor else FlatNet
        critic = PrivNet if cfg.priv_critic else FlatNet
        super().__init__(cfg, n_agents=n_agents, action_dim=action_dim, obs_is_dict=obs_is_dict,
                         device=device,
                         actor_module=functools.partial(actor, out_dim=action_dim, role="actor"),
                         critic_module=functools.partial(critic, out_dim=1, role="critic"))
