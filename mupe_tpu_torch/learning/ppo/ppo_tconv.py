"""PPO with a temporal-convolution encoder over the observation history
(counterpart of mupe_tpu/learning/ppo/ppo_tconv.py).

`TConvEncoder`: Conv1d over the time axis, [64 k1, 64 k7 stride 2, 64 k5
stride 2], VALID, ELU after each, channels-last as flax's `Conv` (kernels
[k, in, out]), flattened time-major (step, then channel) into
`MLP((256,))`; at 32 history frames 5 steps x 64 channels = 320 features.
Float32.  It reads `observation_h` ([..., T, D], Hover's
`obs_history_len` window) from a dict, or the observation itself.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.nn import functional as F

from ..mappo import MAPPOCfg, MAPPOPolicy
from ..modules.networks import HeadNet, Leaf, _feat, apply_mlp, mlp_leaves

_ENC = "TConvEncoder_0"
# (kernel size, stride) of Conv_0..2
_CONVS = ((1, 1), (7, 2), (5, 2))
_CHANNELS = 64


def tconv_steps(t: int) -> int:
    """Time steps left after the three VALID convolutions."""
    for k, stride in _CONVS:
        t = (t - k) // stride + 1
    return t


class TConvEncoder(nn.Module):
    """JAX `TConvEncoder`: x [..., T, D] → [..., 256], its leaves under
    `path`.  Stateless: the leaves come from the owning `LeafNet`."""

    def __init__(self, path: str = _ENC):
        super().__init__()
        self.path = path

    def leaf_specs(self, d: int, t: int):
        leaves, c = [], d
        for i, (k, _) in enumerate(_CONVS):
            leaves += [Leaf(f"{self.path}/Conv_{i}/kernel", (k, c, _CHANNELS)),
                       Leaf(f"{self.path}/Conv_{i}/bias", (_CHANNELS,), "zeros")]
            c = _CHANNELS
        return leaves + mlp_leaves(f"{self.path}/MLP_0", tconv_steps(t) * _CHANNELS, (256,))

    def forward(self, p, x: torch.Tensor) -> torch.Tensor:
        batch = x.shape[:-2]
        h = x.reshape((-1,) + tuple(x.shape[-2:])).transpose(1, 2)        # [B, D, T]
        for i, (_, stride) in enumerate(_CONVS):
            w = p[f"{self.path}/Conv_{i}/kernel"].permute(2, 1, 0)        # [out, in, k]
            h = F.elu(F.conv1d(h, w, p[f"{self.path}/Conv_{i}/bias"], stride=stride))
        h = h.transpose(1, 2).reshape(batch + (-1,))                       # time-major
        return apply_mlp(p, f"{self.path}/MLP_0", h, 1)


class TConvNet(HeadNet):
    """`TConvEncoder` and a head: JAX `_TConvActor` / `_TConvCritic`."""

    def __init__(self, example, out_dim: int, role: str, leaves=None, generator=None):
        super().__init__()
        self.encoder = TConvEncoder()
        self._setup(example, out_dim, role, leaves, generator)

    def body_specs(self, obs):
        x = _feat(obs, "observation_h")
        return self.encoder.leaf_specs(x.shape[-1], x.shape[-2]), 256

    def body(self, p, obs):
        return self.encoder(p, _feat(obs, "observation_h"))


class PPOTConvPolicy(MAPPOPolicy):
    """Observations of shape [..., history, obs_dim], or dicts holding
    them as `observation_h`."""

    def __init__(self, cfg: MAPPOCfg = MAPPOCfg(gamma=0.99, use_tp_net=False),
                 n_agents: int = 1, action_dim: int = 4, obs_is_dict: bool = False,
                 device="cuda"):
        super().__init__(cfg, n_agents=n_agents, action_dim=action_dim, obs_is_dict=obs_is_dict,
                         device=device,
                         actor_module=functools.partial(TConvNet, out_dim=action_dim,
                                                        role="actor"),
                         critic_module=functools.partial(TConvNet, out_dim=1, role="critic"))
