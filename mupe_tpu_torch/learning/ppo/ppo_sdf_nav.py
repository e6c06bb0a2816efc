"""PPO with a PointNet encoder over SDF point observations
(counterpart of mupe_tpu/learning/ppo/ppo_sdf_nav.py).

`PointNetEncoder`: `MLP((64, 64))` on each point, a max over the points,
`MLP((128,))`; the body concatenates it with `MLP((128, 128))` of the flat
`observation` into `MLP((256, 256))` (ppo_sdf_nav.py:18-37).  Float32.
Observations: {"observation": [..., D], "sdf_points": [..., P, 3]}.  No env
of the repo emits `sdf_points`, in the JAX package either.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from ..mappo import MAPPOCfg, MAPPOPolicy
from ..modules.networks import HeadNet, apply_mlp, mlp_leaves

_BODY = "_SDFNavBody_0"
_PN = f"{_BODY}/PointNetEncoder_0"


class PointNetEncoder(nn.Module):
    """JAX `PointNetEncoder`: points [..., P, d] → [..., out_dim], its
    leaves under `path`.  Stateless: the leaves come from the owning
    `LeafNet`."""

    def __init__(self, path: str = _PN, out_dim: int = 128):
        super().__init__()
        self.path, self.out_dim = path, out_dim

    def leaf_specs(self, d: int):
        return (mlp_leaves(f"{self.path}/MLP_0", d, (64, 64))
                + mlp_leaves(f"{self.path}/MLP_1", 64, (self.out_dim,)))

    def forward(self, p, points: torch.Tensor) -> torch.Tensor:
        h = apply_mlp(p, f"{self.path}/MLP_0", points, 2)
        return apply_mlp(p, f"{self.path}/MLP_1", torch.amax(h, dim=-2), 1)


class SDFNavNet(HeadNet):
    """The PointNet body and a head: JAX `_SDFNavActor` / `_SDFNavCritic`."""

    def __init__(self, example, out_dim: int, role: str, leaves=None, generator=None):
        super().__init__()
        self.points = PointNetEncoder()
        self._setup(example, out_dim, role, leaves, generator)

    def body_specs(self, obs):
        return (self.points.leaf_specs(obs["sdf_points"].shape[-1])
                + mlp_leaves(f"{_BODY}/MLP_0", obs["observation"].shape[-1], (128, 128))
                + mlp_leaves(f"{_BODY}/MLP_1", 256, (256, 256))), 256

    def body(self, p, obs):
        pts = self.points(p, obs["sdf_points"])
        state = apply_mlp(p, f"{_BODY}/MLP_0", obs["observation"], 2)
        return apply_mlp(p, f"{_BODY}/MLP_1", torch.cat([pts, state], dim=-1), 2)


class PPOSDFNavPolicy(MAPPOPolicy):
    """Observations: {"observation": flat state, "sdf_points": [..., P, 3]}."""

    def __init__(self, cfg: MAPPOCfg = MAPPOCfg(gamma=0.99, use_tp_net=False),
                 n_agents: int = 1, action_dim: int = 4, device="cuda"):
        super().__init__(cfg, n_agents=n_agents, action_dim=action_dim, obs_is_dict=True,
                         device=device,
                         actor_module=functools.partial(SDFNavNet, out_dim=action_dim,
                                                        role="actor"),
                         critic_module=functools.partial(SDFNavNet, out_dim=1, role="critic"))
