"""Recurrent PPO: GRU cores with episode-boundary masking and BPTT
(counterpart of mupe_tpu/learning/ppo/ppo_rnn.py).

Actor and critic are `MLP((256, 256))` -> `MaskedGRU` (float32) and a head;
acting threads their hidden states explicitly.  `train_op` is the JAX
package's own update (ppo_rnn.py:136-273): GAE on [T, E, n, 1], advantage
normalisation, `ValueNorm1`, then the trajectory cut into BPTT chunks of
`min(train_seq_len, T)` steps that start from the stored pre-step hidden
states (re-zeroed where `is_init` holds), `ppo_epochs` x `num_minibatches`
steps of clip + Adam for each network (the actor's PPO-clip with a fixed
entropy bonus, the critic's clipped Huber); no adaptive entropy, no
target_kl, no log_std floor, no weight decay.  Metrics: `policy_loss` and
`value_loss`.  Across ranks (`train_op(..., shard=)`) R ranks compute the
one-rank update, as MAPPO's does (mupe_tpu_torch/parallel/dist.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..gae import compute_gae
from ...parallel import dist
from ..mappo import MAPPOCfg, MAPPOPolicy, _clipped_huber, _max_branch, _ppo_clip, local_minibatches
from ..modules.distributions import Gaussian
from ..modules.networks import LeafNet, apply_head, apply_mlp, head_leaves, mlp_leaves
from ..modules.rnn import masked_gru, masked_gru_leaves
from ..optim import AdamState, adam_updates, clip_by_global_norm
from ..valuenorm import ValueNorm1

_CORE = "_RNNCore_0"


@dataclasses.dataclass(frozen=True)
class PPORNNCfg(MAPPOCfg):
    train_seq_len: int = 16
    rnn_hidden: int = 128
    gamma: float = 0.99
    use_tp_net: bool = False


class RNNNet(LeafNet):
    """JAX `_RNNActor` / `_RNNCritic`: `_RNNCore` (MLP((256, 256)) ->
    `MaskedGRU`) and the float32 head; one step a call."""

    def __init__(self, obs_dim: int, hidden: int, out_dim: int, role: str, leaves=None,
                 generator=None):
        super().__init__()
        self.obs_dim, self.hidden, self.out_dim, self.role = obs_dim, hidden, out_dim, role
        self._make_flat(leaves, generator)

    def leaf_specs(self):
        return (mlp_leaves(f"{_CORE}/MLP_0", self.obs_dim, (256, 256))
                + masked_gru_leaves(f"{_CORE}/MaskedGRU_0", 256, self.hidden)
                + head_leaves(self.role, self.hidden, self.out_dim))

    def forward(self, obs, state, is_init) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the head's output [..., out], the new hidden state [..., H])."""
        p = self.params()
        feats = apply_mlp(p, f"{_CORE}/MLP_0", obs, 2)
        out, new_state = masked_gru(p, f"{_CORE}/MaskedGRU_0", feats, state, is_init,
                                    self.hidden)
        return apply_head(p, self.role, out), new_state


@dataclasses.dataclass
class PPORNNState:
    """The recurrent learner: both networks, the actor's log_std, both Adam
    states and the value normaliser (JAX's `ts` dict)."""

    actor: RNNNet
    log_std: torch.Tensor
    critic: RNNNet
    actor_opt: Optional[AdamState] = None
    critic_opt: Optional[AdamState] = None
    value_norm: Optional[ValueNorm1] = None

    def actor_params(self) -> List[torch.Tensor]:
        return [self.actor.flat, self.log_std]

    def critic_params(self) -> List[torch.Tensor]:
        return [self.critic.flat]


def _unroll(net: RNNNet, obs, h0, is_init) -> torch.Tensor:
    """The network over a chunk: obs [m, L, ...] from h0 [m, ...] → [m, L, out]."""
    h, outs = h0, []
    for t in range(obs.shape[1]):
        out, h = net(obs[:, t], h, is_init[:, t])
        outs.append(out)
    return torch.stack(outs, dim=1)


class PPORNNPolicy:
    """Self-contained recurrent PPO over flat observations [..., n, D]."""

    def __init__(self, cfg: PPORNNCfg = PPORNNCfg(), n_agents: int = 1, action_dim: int = 4,
                 device="cuda"):
        self.cfg = cfg
        self.n_agents = n_agents
        self.action_dim = action_dim
        self.device = torch.device(device)

    def init(self, obs_example, generator: Optional[torch.Generator] = None,
             actor_leaves=None, log_std=None, critic_leaves=None) -> PPORNNState:
        d, h = obs_example.shape[-1], self.cfg.rnn_hidden
        ts = PPORNNState(
            actor=RNNNet(d, h, self.action_dim, "actor", actor_leaves, generator).to(self.device),
            log_std=torch.as_tensor(torch.zeros(self.action_dim) if log_std is None else log_std,
                                    dtype=torch.float32).clone().to(self.device),
            critic=RNNNet(d, h, 1, "critic", critic_leaves, generator).to(self.device),
            value_norm=ValueNorm1.create((1,), beta=self.cfg.value_norm_beta,
                                         device=self.device),
        )
        ts.actor_opt = AdamState.zeros_like(ts.actor_params())
        ts.critic_opt = AdamState.zeros_like(ts.critic_params())
        return ts

    def zero_state(self, batch_shape: Sequence[int]) -> torch.Tensor:
        return torch.zeros(tuple(batch_shape) + (self.cfg.rnn_hidden,), device=self.device)

    @torch.no_grad()
    def act(self, ts: PPORNNState, obs, actor_rnn, critic_rnn, is_init,
            generator: Optional[torch.Generator] = None, deterministic: bool = False,
            noise: Optional[torch.Tensor] = None):
        """(action, logp [..., 1], value [..., 1], new actor state, new
        critic state); `noise` replaces the generator's standard normal."""
        mean, new_a = ts.actor(obs, actor_rnn, is_init)
        dist = Gaussian(mean=mean, log_std=ts.log_std.expand(mean.shape))
        action = dist.mode if deterministic else dist.sample(generator, noise)
        value, new_c = ts.critic(obs, critic_rnn, is_init)
        return action, dist.log_prob(action)[..., None], value, new_a, new_c

    def _step(self, params, grads, opt: AdamState, lr: float) -> None:
        with torch.no_grad():
            upd, new_opt = adam_updates(clip_by_global_norm(grads, self.cfg.max_grad_norm), opt, lr)
            MAPPOPolicy._write(params, [p + u for p, u in zip(params, upd)], opt, new_opt, None)

    def train_op(self, ts: PPORNNState, batch: Dict[str, Any],
                 generator: Optional[torch.Generator] = None,
                 perms: Optional[torch.Tensor] = None,
                 shard=None) -> Tuple[PPORNNState, Dict[str, torch.Tensor]]:
        """The update on a recurrent rollout (`batch`: the fields of JAX's
        `RNNRollout`, time-major).  Minibatches of chunks are drawn from
        `perms` ([ppo_epochs, chunks] permutations, e.g. the JAX package's)
        or from `generator`.  `shard` (an `EnvShard`) says which arenas of
        the global rollout `batch` holds: chunks are laid out chunk-major
        over the global arenas (chunk c of arena e is row c * E + e, as
        JAX's `chunk` lays them out), the permutation runs over every
        rank's chunks and each rank takes its own; the advantages' moments
        and the losses are global means (the max of the two global Huber
        means), the gradients summed over the ranks."""
        cfg = self.cfg
        t_len, e = batch["reward"].shape[:2]
        e_total = e if shard is None else shard.total
        with torch.no_grad():
            next_value, _ = ts.critic(batch["last_obs"], batch["last_critic_rnn"],
                                      batch["last_is_init"])
            vn = ts.value_norm
            adv, ret = compute_gae(batch["reward"], batch["done"][..., None, :],
                                   vn.denormalize(batch["value"]), vn.denormalize(next_value),
                                   cfg.gamma, cfg.gae_lambda)
            if cfg.normalize_advantages:
                count = adv.numel() // e * e_total
                mean = dist.global_sum(adv) / count
                std = torch.sqrt(dist.global_sum(torch.square(adv - mean)) / count)
                adv = (adv - mean) / (std + 1e-8)
            ts.value_norm = vn.update(ret)
            ret = ts.value_norm.normalize(ret)
        seq = min(cfg.train_seq_len, t_len)
        n_chunk = t_len // seq

        def chunk(x):  # [T, E, ...] → [n_chunk * E, L, ...]
            x = x[: n_chunk * seq].reshape((n_chunk, seq) + tuple(x.shape[1:])).movedim(2, 1)
            return x.reshape((n_chunk * e,) + tuple(x.shape[2:]))

        data = {k: chunk(batch[k]) for k in ("obs", "action", "logp", "value", "is_init")}
        data.update(adv=chunk(adv), ret=chunk(ret), actor_rnn0=chunk(batch["actor_rnn"])[:, 0],
                    critic_rnn0=chunk(batch["critic_rnn"])[:, 0])
        b = n_chunk * e_total
        mb = max(1, b // cfg.num_minibatches)
        # the samples of a global minibatch: the means' normaliser
        n = mb * seq * self.n_agents
        dev = adv.device
        infos: Dict[str, List[torch.Tensor]] = {"policy_loss": [], "value_loss": []}
        for epoch in range(cfg.ppo_epochs):
            perm = (perms[epoch].to(dev) if perms is not None
                    else torch.randperm(b, generator=generator, device=dev))
            mb_idx = perm[: mb * cfg.num_minibatches].reshape(cfg.num_minibatches, mb)
            for idx in local_minibatches(mb_idx, e, shard):
                m = {k: v[idx] for k, v in data.items()}
                ga, gc, glob = self._grads(ts, m, n)
                self._step(ts.actor_params(), ga, ts.actor_opt, cfg.actor_lr)
                self._step(ts.critic_params(), gc, ts.critic_opt, cfg.critic_lr)
                infos["policy_loss"].append(glob[0])
                infos["value_loss"].append(torch.maximum(glob[1], glob[2]))
        return ts, {k: torch.mean(torch.stack(v)) for k, v in infos.items()}

    def _grads(self, ts: PPORNNState, m: Dict[str, torch.Tensor], n: int):
        """A minibatch's gradients, summed over the ranks: (actor [flat,
        log_std], critic [flat], the policy loss and the two Huber means
        over every rank).  Every mean divides by `n`, the global minibatch's
        samples; the value loss takes the branch the global means choose.  A
        rank without rows of the minibatch joins with zeros."""
        cfg = self.cfg
        if m["logp"].shape[0] == 0:
            grads = [torch.zeros_like(p) for p in ts.actor_params() + ts.critic_params()]
            local = torch.zeros(3, device=ts.log_std.device)
            glob = dist.all_reduce_sum(local)
        else:
            with torch.enable_grad():
                log_std = ts.log_std.detach().requires_grad_(True)
                mean = _unroll(ts.actor, m["obs"], m["actor_rnn0"], m["is_init"])
                dist_ = Gaussian(mean, log_std.expand(mean.shape))
                _, pl = _ppo_clip(cfg, dist_.log_prob(m["action"])[..., None], m["logp"], m["adv"],
                                  self.action_dim, n)
                loss = pl + cfg.entropy_coef * (-torch.sum(dist_.entropy()) / n)
                ga = list(torch.autograd.grad(loss, [ts.actor.flat, log_std]))
                vs = _unroll(ts.critic, m["obs"], m["critic_rnn0"], m["is_init"])
                h1, h2 = _clipped_huber(cfg, vs, m["value"], m["ret"], n)
                glob = dist.all_reduce_sum(torch.stack([pl.detach(), h1.detach(), h2.detach()]))
                gc = list(torch.autograd.grad(_max_branch(h1, h2, glob[1], glob[2]),
                                              [ts.critic.flat]))
            grads = ga + gc
        grads = dist.all_reduce_tensors(grads)
        return grads[:2], grads[2:], glob
