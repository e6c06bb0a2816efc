"""Transformer-token PPO over entity observations
(counterpart of mupe_tpu/learning/ppo/transformer.py).

Each observation group (every key but "mask", in sorted key order: the
order in which the JAX package's compiled programs see a dict) is projected
to 128-wide tokens by Dense -> ELU -> Dense -> LayerNorm; two pre-norm
transformer blocks (4 heads of 32, a GELU feed-forward of 256) mix them.
Per-agent observations (`per_agent_obs`, HideAndSeek's [..., n, k, d]
groups) read each agent's token 0; a global token set ([..., k, d]) reads
the first n tokens, one an agent.  The actor's MLP((128, 128)) reads the
raw token beside the mixed one.  Float32 throughout; flax's LayerNorm
epsilon (1e-6), its tanh GELU, and its attention (the query scaled by
1/sqrt(head_dim), the softmax in float32).
"""
from __future__ import annotations

import functools
import math
from typing import Dict

import torch
from torch import nn
from torch.nn import functional as F

from ..mappo import MAPPOCfg, MAPPOPolicy
from ..modules.networks import (
    HeadNet,
    apply_dense,
    apply_ln,
    apply_mlp,
    dense_leaves,
    ln_leaves,
    mlp_leaves,
)

EMBED, HEADS, LAYERS, FF = 128, 4, 2, 256
_EMB, _ENC = "_TokenEmbed_0", "TransformerEncoder_0"


def token_keys(obs) -> list:
    return sorted(k for k in obs if k != "mask")


def token_embed_leaves(obs):
    leaves = []
    for k in token_keys(obs):
        leaves += (dense_leaves(f"{_EMB}/proj1_{k}", obs[k].shape[-1], EMBED)
                   + dense_leaves(f"{_EMB}/proj2_{k}", EMBED, EMBED)
                   + ln_leaves(f"{_EMB}/norm_{k}", EMBED))
    return leaves


def token_embed(p, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """JAX `_TokenEmbed`: [..., K, 128] tokens."""
    tokens = []
    for k in token_keys(obs):
        h = F.elu(apply_dense(p, f"{_EMB}/proj1_{k}", obs[k]))
        tokens.append(apply_ln(p, f"{_EMB}/norm_{k}", apply_dense(p, f"{_EMB}/proj2_{k}", h)))
    return torch.cat(tokens, dim=-2)




def self_attention(p, path: str, y: torch.Tensor) -> torch.Tensor:
    """flax `MultiHeadDotProductAttention(4 heads, qkv 128)(y, y)`: the
    kernels are [in, heads * head_dim] (flax's [in, heads, head_dim]
    row-major), the out kernel [heads * head_dim, out]."""
    hd = EMBED // HEADS
    split = lambda t: t.reshape(t.shape[:-1] + (HEADS, hd))
    q = split(apply_dense(p, f"{path}/query", y)) / math.sqrt(hd)
    k = split(apply_dense(p, f"{path}/key", y))
    v = split(apply_dense(p, f"{path}/value", y))
    w = torch.softmax(torch.einsum("...qhd,...khd->...hqk", q, k), dim=-1)
    out = torch.einsum("...hqk,...khd->...qhd", w, v)
    return apply_dense(p, f"{path}/out", out.reshape(out.shape[:-2] + (EMBED,)))


class TransformerEncoder(nn.Module):
    """JAX `TransformerEncoder`: pre-norm blocks over the token axis, its
    leaves under `path`.  Stateless: the leaves come from the owning
    `LeafNet`."""

    def __init__(self, path: str = _ENC):
        super().__init__()
        self.path = path

    def leaf_specs(self):
        leaves, n = [], self.path
        for i in range(LAYERS):
            leaves += ln_leaves(f"{n}/LayerNorm_{2 * i}", EMBED)
            for proj in ("query", "key", "value", "out"):
                leaves += dense_leaves(f"{n}/attn_{i}/{proj}", EMBED, EMBED)
            leaves += (ln_leaves(f"{n}/LayerNorm_{2 * i + 1}", EMBED)
                       + dense_leaves(f"{n}/Dense_{2 * i}", EMBED, FF)
                       + dense_leaves(f"{n}/Dense_{2 * i + 1}", FF, EMBED))
        return leaves

    def forward(self, p, x: torch.Tensor) -> torch.Tensor:
        n = self.path
        for i in range(LAYERS):
            x = x + self_attention(p, f"{n}/attn_{i}", apply_ln(p, f"{n}/LayerNorm_{2 * i}", x))
            y = apply_ln(p, f"{n}/LayerNorm_{2 * i + 1}", x)
            y = F.gelu(apply_dense(p, f"{n}/Dense_{2 * i}", y), approximate="tanh")
            x = x + apply_dense(p, f"{n}/Dense_{2 * i + 1}", y)
        return x


class TransformerNet(HeadNet):
    """Tokens, the transformer, an MLP((128, 128)) and a head: JAX
    `_TransformerActor` (the raw token beside the mixed one) /
    `_TransformerCritic` (the mixed one)."""

    def __init__(self, example, out_dim: int, role: str, n_agents: int,
                 per_agent_obs: bool = False, leaves=None, generator=None):
        super().__init__()
        self.n_agents, self.per_agent_obs = n_agents, per_agent_obs
        self.encoder = TransformerEncoder()
        self._setup(example, out_dim, role, leaves, generator)

    def body_specs(self, obs):
        width = 2 * EMBED if self.role == "actor" else EMBED
        return token_embed_leaves(obs) + self.encoder.leaf_specs() + mlp_leaves(
            "MLP_0", width, (128, 128)), 128

    def body(self, p, obs):
        tokens = token_embed(p, obs)
        feats = self.encoder(p, tokens)
        n = 1 if self.per_agent_obs else self.n_agents
        if self.role == "actor":
            x = torch.cat([tokens[..., :n, :], feats[..., :n, :]], dim=-1)
        else:
            x = feats[..., :n, :]
        if self.per_agent_obs:
            x = x[..., 0, :]
        return apply_mlp(p, "MLP_0", x, 2)

    def forward(self, obs):
        out = super().forward(obs)
        if self.role == "critic" and not self.per_agent_obs and self.n_agents == 1:
            out = out[..., 0, :]  # _TransformerCritic's v[..., 0, :]
        return out


class TransformerPPOPolicy(MAPPOPolicy):
    """Entity-token PPO: dict observations of [..., k_i, d_i] groups (a
    global token set, agents first) or, with `per_agent_obs`, of
    [..., n, k_i, d_i] groups; actions per agent."""

    def __init__(self, cfg: MAPPOCfg = MAPPOCfg(use_tp_net=False), n_agents: int = 1,
                 action_dim: int = 4, per_agent_obs: bool = False, device="cuda"):
        net = functools.partial(TransformerNet, n_agents=n_agents, per_agent_obs=per_agent_obs)
        super().__init__(cfg, n_agents=n_agents, action_dim=action_dim, obs_is_dict=True,
                         device=device, actor_module=functools.partial(net, out_dim=action_dim,
                                                                       role="actor"),
                         critic_module=functools.partial(net, out_dim=1, role="critic"))
