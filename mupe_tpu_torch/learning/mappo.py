"""MAPPO (counterpart of mupe_tpu/learning/mappo.py): acting and the update.

Over dict observations of entity groups the actor and the critic are
PartialAttentionEncoder networks with linear heads, held as canonical
parameter leaves (mupe_tpu_torch/ops/fused_encoder.py); `act` runs both in
one `encoder_pair_forward` launch and `value_op` runs the critic through
`encoder_forward`.  `train_op` is then the update of the JAX package's
packed path: GAE, `ValueNorm1`, the TP net's supervised step and the joint
PPO minibatches of `_update_joint_flat`, whose gradients come from the
backward kernels through the autograd Functions under the forward wrappers,
or, with `use_inkernel_loss`, of `_update_joint_direct`, whose loss
gradients come out of the forward kernel itself (`pair_ppo_grads_fwdloss` /
`pair_ppo_grads`).

Over flat observations ([..., n, D], Hover's) the actor and the critic are
`FlatHeadNet`s (LayerNorm + MLP in `compute_dtype`, float32 heads) in plain
torch, as in the JAX package, whose flat path runs no kernel; `train_op`
takes JAX's non-joint branch: per minibatch `_update_actor`, then
`_update_critic`, each with its own loss, clip and Adam step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.fused_encoder import (
    _LOG_SQRT_2PI,
    _SUM_H1,
    _SUM_H2,
    _SUM_LOGR,
    _SUM_MIN12,
    _SUM_RATIO,
    _SUM_RATIO2,
    _SUM_RET,
    _SUM_RET2,
    _SUM_SQERR,
    EncoderSpec,
    PPOLossCfg,
    encoder_forward,
    encoder_pair_forward,
    leaf_shapes,
    pack_obs,
    pair_ppo_grads,
    pair_ppo_grads_fwdloss,
    split_flat,
)
from .modules.distributions import Gaussian
from .modules.networks import (
    FlatHeadNet,
    entity_group_order,
    init_flat_leaves,
    lecun_normal,
    orthogonal,
)
from .gae import compute_gae
from .optim import AdamState, adam_updates, clip_by_global_norm, global_norm
from .tp_net import TPNet
from .valuenorm import ValueNorm1


def _gaussian_entropy(log_std: torch.Tensor) -> torch.Tensor:
    """The diagonal Gaussian's entropy (it does not depend on the mean)."""
    return torch.sum(log_std) + log_std.shape[-1] * 0.5 * (1.0 + math.log(2.0 * math.pi))


@dataclasses.dataclass(frozen=True)
class MAPPOCfg:
    """Hyper-parameters (reference cfg/algo/mappo.yaml); the fields and
    defaults of the JAX package's MAPPOCfg without its TPU launch knobs
    (use_fused_encoder, use_fused_act, pack_rollout).  `use_inkernel_loss`
    selects the update whose loss gradients come out of the forward kernel
    (`_update_joint_direct`); `direct_mode`, the port's counterpart of the
    JAX package's MUPE_DIRECT_MODE environment variable, picks its kernel:
    "fwdloss" (forward + loss, then the pair backward) or "agrad" (forward +
    loss + the actor's backward in one kernel, then the critic's backward)."""

    train_every: int = 64
    num_minibatches: int = 16
    ppo_epochs: int = 4
    tp_epochs: int = 1
    clip_param: float = 0.1
    entropy_coef: float = 0.001
    gamma: float = 0.995
    gae_lambda: float = 0.95
    actor_lr: float = 5e-4
    critic_lr: float = 5e-4
    tp_lr: float = 1e-4
    weight_decay: float = 0.0
    max_grad_norm: float = 10.0
    share_actor: bool = True
    critic_input: str = "obs"
    normalize_advantages: bool = True
    use_tp_net: bool = False
    value_norm_beta: float = 0.995
    hidden_units: Tuple[int, ...] = (256, 256, 256)
    attn_encoder: str = "PartialAttentionEncoder"
    huber_delta: float = 10.0
    future_prediction_step: int = 5
    window_step: int = 1
    compute_dtype: str = "bfloat16"
    entropy_target: Optional[float] = None
    entropy_adapt_speed: float = 0.02
    entropy_coef_min: float = 1e-5
    entropy_coef_max: float = 0.1
    entropy_deadband: float = 0.2
    entropy_err_clip: float = 1.0
    target_kl: Optional[float] = None
    min_log_std: Optional[float] = None
    use_inkernel_loss: bool = False
    direct_mode: str = "fwdloss"


DIRECT_MODES = ("fwdloss", "agrad")
# dict-observation branches that are not entity groups: Hover's with domain
# randomization (intrinsics) or an observation history; ppo_adapt's inputs
_NON_ENTITY_KEYS = ("observation", "intrinsics", "observation_h", "depth")


class EncoderHead(nn.Module):
    """The parameters of one encoder + linear head: one flat vector (the
    layout `optax.flatten` gives the JAX optimizer) whose views are the
    canonical leaves (Wg, bg per group, ln0, Wq, bq, Wk, bk, Wv, bv, Wo, bo,
    ln1, W1, b1, W2, b2, ln2, Wh, bh); `MAPPOPolicy` runs them through the
    kernel wrappers, and gradients reach `flat` through the views."""

    def __init__(self, spec: EncoderSpec, leaves: Sequence[torch.Tensor]):
        super().__init__()
        shapes = leaf_shapes(spec)
        if len(leaves) != len(shapes):
            raise ValueError(f"{len(leaves)} leaves, spec wants {len(shapes)}")
        for i, (leaf, shape) in enumerate(zip(leaves, shapes)):
            if tuple(leaf.shape) != shape:
                raise ValueError(f"leaf {i}: shape {tuple(leaf.shape)} != {shape}")
        self.spec = spec
        self.flat = nn.Parameter(torch.cat(
            [torch.as_tensor(l, dtype=torch.float32).reshape(-1) for l in leaves]))

    @property
    def leaves(self) -> List[torch.Tensor]:
        return list(split_flat(self.spec, self.flat))


def init_encoder_leaves(spec: EncoderSpec, head: str, generator=None):
    """The flax initializers of the JAX Actor / Critic: lecun-normal Dense
    and attention kernels, zero biases, unit LayerNorm scales; the actor
    head is xavier-uniform with gain 0.01, the critic head orthogonal(0.01)."""
    leaves = []
    shapes = leaf_shapes(spec)
    ln_idx = {2 * len(spec.groups) + i for i in (0, 1, 10, 11, 16, 17)}
    for i, shape in enumerate(shapes[:-2]):
        if i in ln_idx:
            leaves.append(torch.ones(shape) if i % 2 == 0 else torch.zeros(shape))
        elif len(shape) == 2:
            leaves.append(lecun_normal(shape, generator))
        else:
            leaves.append(torch.zeros(shape))
    e, h = spec.embed_dim, spec.head_dim
    if head == "actor":
        bound = 0.01 * math.sqrt(6.0 / (e + h))
        wh = (torch.rand((e, h), generator=generator) * 2.0 - 1.0) * bound
    else:
        wh = 0.01 * orthogonal(e, h, generator)
    return leaves + [wh, torch.zeros(h)]


@dataclasses.dataclass
class MAPPOState:
    """All learnable state: parameters, optimizer states, the value
    normaliser and (with `entropy_target`) the adaptive entropy coefficient.
    `train_op` updates it in place (the tensors' storage is reused).  The
    networks are `EncoderHead`s over dict observations, `FlatHeadNet`s over
    flat ones."""

    actor: EncoderHead | FlatHeadNet
    log_std: torch.Tensor          # [A]
    critic: EncoderHead | FlatHeadNet
    tp_net: Optional[TPNet] = None
    actor_opt: Optional[AdamState] = None   # over [actor.flat, log_std]
    critic_opt: Optional[AdamState] = None  # over [critic.flat]
    tp_opt: Optional[AdamState] = None      # over the TP net's five leaves
    value_norm: Optional[ValueNorm1] = None
    entropy_coef: Optional[torch.Tensor] = None

    def actor_params(self) -> List[torch.Tensor]:
        return [self.actor.flat, self.log_std]

    def critic_params(self) -> List[torch.Tensor]:
        return [self.critic.flat]


@dataclasses.dataclass(frozen=True)
class PackMeta:
    """Lane layout of one packed row (one (t, env) sample), as
    mupe_tpu/learning/mappo.py:204-249 has it:
    [ obs: n_agents x (entity groups in order) | action n*A | logp n |
      value n | advantages n | returns n ]."""

    names: Tuple[str, ...]
    groups: Tuple[Tuple[int, int], ...]
    n_agents: int
    action_dim: int

    @property
    def obs_dim(self) -> int:
        return sum(k * d for k, d in self.groups)

    @property
    def obs_cols(self) -> int:
        return self.n_agents * self.obs_dim

    @property
    def off_action(self) -> int:
        return self.obs_cols

    @property
    def off_logp(self) -> int:
        return self.off_action + self.n_agents * self.action_dim

    @property
    def off_value(self) -> int:
        return self.off_logp + self.n_agents

    @property
    def off_adv(self) -> int:
        return self.off_value + self.n_agents

    @property
    def off_ret(self) -> int:
        return self.off_adv + self.n_agents

    @property
    def total(self) -> int:
        return self.off_ret + self.n_agents


def compute_pack_meta(obs_example, n_agents: int, action_dim: int) -> PackMeta:
    """The packed-row layout of an observation dict (leaves [..., n, k, d])."""
    names = tuple(entity_group_order(obs_example.keys()))
    groups = tuple((obs_example[n].shape[-2], obs_example[n].shape[-1]) for n in names)
    return PackMeta(names=names, groups=groups, n_agents=n_agents, action_dim=action_dim)


def pack_rows(meta: PackMeta, obs, action, logp, value, advantages, returns) -> torch.Tensor:
    """[T, E, ...] trajectory fields → [T*E, total] rows in `meta`'s layout."""
    b, n = action.shape[0] * action.shape[1], meta.n_agents
    x = torch.cat([obs[nm].reshape(b, n, -1) for nm in meta.names], dim=-1).reshape(b, -1)
    return torch.cat([x, action.reshape(b, -1), logp.reshape(b, n), value.reshape(b, n),
                      advantages.reshape(b, n), returns.reshape(b, n)], dim=-1)


def unpack_rows(meta: PackMeta, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Minibatch rows → the kernels' [m*n, obs_dim] rows and flat [m*n]
    per-sample fields (the flat `unpack` of mappo.py:658-684)."""
    m, n = rows.shape[0], meta.n_agents

    def lanes(off, width):
        return rows[:, off : off + width]

    return {
        "obs_rows": rows[:, : meta.obs_cols].reshape(m * n, meta.obs_dim),
        "action": lanes(meta.off_action, n * meta.action_dim).reshape(m * n, meta.action_dim),
        "logp": lanes(meta.off_logp, n).reshape(m * n),
        "value": lanes(meta.off_value, n).reshape(m * n),
        "advantages": lanes(meta.off_adv, n).reshape(m * n),
        "returns": lanes(meta.off_ret, n).reshape(m * n),
    }


def _huber(pred, target, delta):
    """mean of optax.huber_loss."""
    abs_err = torch.abs(pred - target)
    quadratic = torch.minimum(abs_err, torch.full_like(abs_err, delta))
    linear = abs_err - quadratic
    return torch.mean(0.5 * quadratic ** 2 + delta * linear)


class MAPPOPolicy:
    """Static algorithm object; methods are functions of a `MAPPOState`."""

    def __init__(
        self,
        cfg: MAPPOCfg,
        n_agents: int,
        action_dim: int,
        obs_is_dict: bool,
        tp_input_dim: Optional[int] = None,
        device: torch.device | str = "cuda",
        tp_history_step: int = 10,
    ):
        unsupported = {
            "share_actor=False": not cfg.share_actor,
            f"critic_input={cfg.critic_input!r}": cfg.critic_input != "obs",
            f"attn_encoder={cfg.attn_encoder!r}":
                cfg.attn_encoder != "PartialAttentionEncoder",
        }
        for what, on in unsupported.items():
            if on:
                raise NotImplementedError(f"MAPPO {what} is not ported yet")
        if cfg.use_tp_net and tp_input_dim is None:
            raise ValueError("use_tp_net needs tp_input_dim")
        if cfg.direct_mode not in DIRECT_MODES:
            raise ValueError(f"direct_mode {cfg.direct_mode!r} is not one of {DIRECT_MODES}")
        self.cfg = cfg
        self.n_agents = n_agents
        self.action_dim = action_dim
        self.obs_is_dict = obs_is_dict
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.tp_input_dim = tp_input_dim
        self.tp_history_step = tp_history_step
        self.device = torch.device(device)

    def specs(self, obs: Dict[str, torch.Tensor]):
        """(group names, actor spec, critic spec) for a dict observation
        with leaves [..., k, d]."""
        other = [k for k in obs if k in _NON_ENTITY_KEYS]
        if other:
            raise NotImplementedError(
                f"MAPPO cannot train dict observations with the branches {other} (Hover "
                "with dr_* ranges or obs_history_len): they are ppo_adapt's inputs, not "
                "ported yet (ROADMAP A3b); the JAX package's MAPPO fails on them too")
        names = entity_group_order(obs.keys())
        groups = tuple((obs[n].shape[-2], obs[n].shape[-1]) for n in names)
        return (names, EncoderSpec(groups=groups, head_dim=self.action_dim),
                EncoderSpec(groups=groups, head_dim=1))

    def init(
        self,
        obs_example,
        generator: Optional[torch.Generator] = None,
        actor_leaves=None,
        log_std=None,
        critic_leaves=None,
        tp_leaves=None,
    ) -> MAPPOState:
        """Parameters from given leaves (e.g. converted by `bridge`) or, for
        any not given, initialised from `generator` (a CPU generator).
        `obs_example` is a dict of entity groups, or a flat [..., n, D]
        observation."""
        if self.obs_is_dict:
            _, spec_a, spec_c = self.specs(obs_example)
            if actor_leaves is None:
                actor_leaves = init_encoder_leaves(spec_a, "actor", generator)
            if critic_leaves is None:
                critic_leaves = init_encoder_leaves(spec_c, "critic", generator)
            actor, critic = EncoderHead(spec_a, actor_leaves), EncoderHead(spec_c, critic_leaves)
        else:
            d, hidden, dt = obs_example.shape[-1], self.cfg.hidden_units, self.compute_dtype
            if actor_leaves is None:
                actor_leaves = init_flat_leaves(d, hidden, self.action_dim, "actor", generator)
            if critic_leaves is None:
                critic_leaves = init_flat_leaves(d, hidden, 1, "critic", generator)
            actor = FlatHeadNet(d, hidden, self.action_dim, dt, actor_leaves)
            critic = FlatHeadNet(d, hidden, 1, dt, critic_leaves)
        if log_std is None:
            log_std = torch.zeros(self.action_dim)
        tp_net = None
        if self.cfg.use_tp_net:
            tp_net = TPNet(
                self.tp_input_dim, 3 * self.cfg.future_prediction_step,
                history_step=self.tp_history_step, leaves=tp_leaves, generator=generator, device=self.device,
            )
        ts = MAPPOState(
            actor=actor.to(self.device),
            log_std=torch.as_tensor(log_std, dtype=torch.float32).to(self.device),
            critic=critic.to(self.device),
            tp_net=tp_net,
            value_norm=ValueNorm1.create((1,), beta=self.cfg.value_norm_beta, device=self.device),
        )
        ts.actor_opt = AdamState.zeros_like(ts.actor_params())
        ts.critic_opt = AdamState.zeros_like(ts.critic_params())
        if tp_net is not None:
            ts.tp_opt = AdamState.zeros_like(list(tp_net.leaves()))
        if self.cfg.entropy_target is not None:
            ts.entropy_coef = torch.tensor(self.cfg.entropy_coef, device=self.device)
        return ts

    @torch.no_grad()
    def value_op(self, ts: MAPPOState, obs) -> torch.Tensor:
        """V(s) per agent → [..., n, 1] (the critic alone: `encoder_forward`,
        or the flat critic)."""
        if not self.obs_is_dict:
            return ts.critic(obs)
        names, _, spec_c = self.specs(obs)
        x, lead = pack_obs(spec_c, obs, names)
        return encoder_forward(spec_c, list(ts.critic.leaves), x).reshape(lead + (1,))

    @torch.no_grad()
    def act(
        self,
        ts: MAPPOState,
        obs,
        generator: Optional[torch.Generator] = None,
        deterministic: bool = False,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Sample actions → (action, logp [..., n, 1], value [..., n, 1]).
        Over dict observations actor and critic run in one
        `encoder_pair_forward` launch.  `noise` (standard normal, the
        action's shape) replaces the generator's draw."""
        if self.obs_is_dict:
            names, spec_a, spec_c = self.specs(obs)
            x, lead = pack_obs(spec_a, obs, names)
            mean, value = encoder_pair_forward(
                spec_a, spec_c, list(ts.actor.leaves), list(ts.critic.leaves), x
            )
            mean = mean.reshape(lead + (self.action_dim,))
        else:
            mean, value = ts.actor(obs), ts.critic(obs)
            lead = tuple(obs.shape[:-1])
        dist = Gaussian(mean=mean, log_std=ts.log_std.expand(mean.shape))
        action = dist.mode if deterministic else dist.sample(generator, noise)
        return action, dist.log_prob(action)[..., None], value.reshape(lead + (1,))

    # ------------------------------------------------------------------ train
    def _entropy_coef(self, ts: MAPPOState):
        """The static cfg value, or the adaptive scalar of the state."""
        return ts.entropy_coef if self.cfg.entropy_target is not None else self.cfg.entropy_coef

    def _apply_log_std_floor(self, log_std: torch.Tensor) -> torch.Tensor:
        if self.cfg.min_log_std is None:
            return log_std
        return torch.clamp(log_std, min=self.cfg.min_log_std)

    @staticmethod
    def _write(params, new, opt: AdamState, new_opt: AdamState, stop) -> None:
        """Store a step's parameters and optimizer state; with a `stop` flag
        (target_kl) the old values are kept where it is set, as
        `jnp.where(stop, old, new)` does (mappo.py:755-757)."""
        with torch.no_grad():
            for dst, src in zip(params + opt.tensors(), new + new_opt.tensors()):
                if stop is None:
                    dst.copy_(src)
                else:
                    dst.copy_(torch.where(stop, dst, src))

    def train_op(
        self,
        ts: MAPPOState,
        traj: Dict[str, Any],
        last_obs: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        perms: Optional[torch.Tensor] = None,
        mark: Optional[Callable[[str], None]] = None,
    ) -> Tuple[MAPPOState, Dict[str, torch.Tensor]]:
        """The update (mappo.py:593-806) on a rollout's trajectory: bootstrap
        value, flat GAE + advantage normalisation + `ValueNorm1`, the TP
        net's supervised step, then `ppo_epochs` x `num_minibatches` joint
        actor+critic steps (`_update_joint_flat`, or `_update_joint_direct`
        with `use_inkernel_loss`), or over flat observations an actor step
        and a critic step (`_update_actor_critic`).  Minibatches are drawn
        from `perms` ([ppo_epochs, T*E] permutations, e.g. the JAX package's) or from
        `generator`.  Metrics stay device tensors (no host sync).  `mark`,
        if given, is called with "prep", "tp" and "ppo" as each phase ends
        (a timer may synchronise there)."""
        cfg = self.cfg
        t_len, e, n_ag = traj["reward"].shape[:3]
        with torch.no_grad():
            next_value = self.value_op(ts, last_obs)
            values = ts.value_norm.denormalize(traj["value"].reshape(t_len, e * n_ag))
            next_value = ts.value_norm.denormalize(next_value.reshape(e * n_ag))
            reward = traj["reward"].reshape(t_len, e * n_ag)
            done = traj["done"][:, :, None, 0].expand(t_len, e, n_ag).reshape(t_len, e * n_ag)
            advantages, returns = compute_gae(reward, done, values, next_value,
                                              cfg.gamma, cfg.gae_lambda)
            adv_mean = torch.mean(advantages)
            adv_std = torch.std(advantages, correction=0)
            if cfg.normalize_advantages:
                advantages = (advantages - adv_mean) / (adv_std + 1e-8)
            ts.value_norm = ts.value_norm.update(returns[..., None])
            returns = ts.value_norm.normalize(returns)
            if self.obs_is_dict:
                meta = compute_pack_meta(last_obs, self.n_agents, self.action_dim)
                packed = pack_rows(meta, traj["obs"], traj["action"], traj["logp"],
                                   traj["value"], advantages, returns)

                def minibatch(idx):
                    return unpack_rows(meta, packed[idx])

                update = (self._update_joint_direct if cfg.use_inkernel_loss
                          else self._update_joint_flat)
            else:
                # the JAX package's non-joint layout: [T*E, n, ...] per field
                fields = {"obs": traj["obs"], "action": traj["action"], "logp": traj["logp"],
                          "value": traj["value"],
                          "advantages": advantages.reshape(t_len, e, n_ag, 1),
                          "returns": returns.reshape(t_len, e, n_ag, 1)}
                fields = {k: v.reshape((t_len * e,) + tuple(v.shape[2:]))
                          for k, v in fields.items()}

                def minibatch(idx):
                    return {k: v[idx] for k, v in fields.items()}

                update = self._update_actor_critic
        mark = mark or (lambda name: None)
        mark("prep")
        metrics: Dict[str, torch.Tensor] = {"advantages_mean": adv_mean,
                                            "advantages_std": adv_std}
        if ts.tp_net is not None and "tp_input" in traj:
            metrics.update(self._update_tp(ts, traj))
        mark("tp")

        b = t_len * e
        mb_size = b // cfg.num_minibatches
        dev = advantages.device
        stop = (torch.zeros((), dtype=torch.bool, device=dev)
                if cfg.target_kl is not None else None)
        infos: Dict[str, List[torch.Tensor]] = {}
        for epoch in range(cfg.ppo_epochs):
            if perms is not None:
                perm = perms[epoch].to(dev)
            else:
                perm = torch.randperm(b, generator=generator, device=dev)
            mb_idx = perm[: mb_size * cfg.num_minibatches].reshape(cfg.num_minibatches, mb_size)
            for idx in mb_idx:
                info = update(ts, minibatch(idx), stop)
                if stop is not None:
                    stop = torch.logical_or(stop, info["approx_kl"] > cfg.target_kl)
                    info["kl_stop"] = stop.to(torch.float32)
                for k, v in info.items():
                    infos.setdefault(k, []).append(v)
        with torch.no_grad():
            metrics.update({k: torch.mean(torch.stack(v)) for k, v in infos.items()})
            if cfg.entropy_target is not None:
                err = cfg.entropy_target - metrics["entropy"]
                err = torch.sign(err) * torch.clamp(torch.abs(err) - cfg.entropy_deadband, min=0.0)
                err = torch.clamp(err, -cfg.entropy_err_clip, cfg.entropy_err_clip)
                ts.entropy_coef = torch.clamp(
                    ts.entropy_coef * torch.exp(cfg.entropy_adapt_speed * err),
                    cfg.entropy_coef_min, cfg.entropy_coef_max)
                metrics["entropy_coef"] = ts.entropy_coef
            metrics["action_norm"] = torch.mean(torch.linalg.vector_norm(traj["action"], dim=-1))
            metrics["value_running_mean"] = torch.mean(ts.value_norm.running_mean)
        mark("ppo")
        return ts, metrics

    def _joint_grads(self, ts: MAPPOState, mb: Dict[str, torch.Tensor]):
        """The joint loss of `_update_joint_flat` (mappo.py:974-1012) and its
        gradients: the pair forward (one kernel launch), the PPO-clip +
        clipped-Huber loss on flat [s] vectors in plain torch, and the pair
        backward (one kernel launch, through the autograd Function).
        Returns ([d actor.flat, d log_std], [d critic.flat], the loss terms)."""
        cfg = self.cfg
        act, logp_old, adv = mb["action"], mb["logp"], mb["advantages"]
        b_values, b_returns = mb["value"], mb["returns"]
        with torch.enable_grad():
            mean, values = encoder_pair_forward(ts.actor.spec, ts.critic.spec, ts.actor.leaves,
                                                ts.critic.leaves, mb["obs_rows"])
            values = values[:, 0]
            log_std = ts.log_std.detach().requires_grad_(True)
            z = (act - mean) * torch.exp(-log_std)
            logp_new = torch.sum(-0.5 * torch.square(z) - log_std - _LOG_SQRT_2PI, dim=-1)
            entropy = _gaussian_entropy(log_std)
            ratio = torch.exp(torch.clamp(logp_new - logp_old, -20.0, 20.0))
            surr1 = ratio * adv
            surr2 = torch.clamp(ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param) * adv
            policy_loss = -torch.mean(torch.minimum(surr1, surr2) * self.action_dim)
            clipped = b_values + torch.clamp(values - b_values, -cfg.clip_param, cfg.clip_param)
            value_loss = torch.maximum(_huber(values, b_returns, cfg.huber_delta),
                                       _huber(clipped, b_returns, cfg.huber_delta))
            total = policy_loss - entropy * self._entropy_coef(ts) + value_loss
            ga_enc, ga_ls, gc = torch.autograd.grad(
                total, [ts.actor.flat, log_std, ts.critic.flat])
        terms = dict(policy_loss=policy_loss.detach(), entropy=entropy.detach(),
                     value_loss=value_loss.detach(), ratio=ratio.detach(),
                     values=values.detach())
        return [ga_enc, ga_ls], [gc], terms

    def _actor_step(self, ts: MAPPOState, ga, stop) -> None:
        """Clip + Adam for the actor (log_std in its global norm, then its
        floor), written into `ts` (held where `stop` is set)."""
        cfg = self.cfg
        with torch.no_grad():
            upd, opt = adam_updates(clip_by_global_norm(ga, cfg.max_grad_norm),
                                    ts.actor_opt, cfg.actor_lr)
            new = [p + u for p, u in zip(ts.actor_params(), upd)]
            new[1] = self._apply_log_std_floor(new[1])
            self._write(ts.actor_params(), new, ts.actor_opt, opt, stop)

    def _critic_step(self, ts: MAPPOState, gc, stop) -> None:
        """Clip + Adam for the critic, AdamW's decoupled decay on every leaf
        where `weight_decay > 0` (the JAX critic's `optax.adamw`), written
        into `ts` (held where `stop` is set)."""
        cfg = self.cfg
        with torch.no_grad():
            params = ts.critic_params()
            upd, opt = adam_updates(clip_by_global_norm(gc, cfg.max_grad_norm), ts.critic_opt,
                                    cfg.critic_lr, weight_decay=cfg.weight_decay, params=params)
            self._write(params, [p + u for p, u in zip(params, upd)], ts.critic_opt, opt, stop)

    def _step(self, ts: MAPPOState, ga, gc, stop) -> None:
        """`_actor_step` and `_critic_step`: the joint updates' optimizers."""
        self._actor_step(ts, ga, stop)
        self._critic_step(ts, gc, stop)

    def _update_joint_flat(
        self, ts: MAPPOState, mb: Dict[str, torch.Tensor], stop=None
    ) -> Dict[str, torch.Tensor]:
        """One minibatch (mappo.py:949-1045): `_joint_grads`, then clip +
        Adam for the actor (log_std in its global norm) and the critic;
        returns the info metrics."""
        ga, gc, terms = self._joint_grads(ts, mb)
        self._step(ts, ga, gc, stop)
        with torch.no_grad():
            ratio, values, b_returns = terms["ratio"], terms["values"], mb["returns"]
            explained_var = 1.0 - torch.mean(torch.square(values - b_returns)) / (
                torch.var(b_returns, correction=0) + 1e-8)
            return {
                "policy_loss": terms["policy_loss"],
                "actor_grad_norm": global_norm(ga),
                "entropy": terms["entropy"],
                "ESS": torch.square(torch.sum(ratio))
                / (torch.sum(torch.square(ratio)) * ratio.shape[0]),
                "value_loss": terms["value_loss"],
                "critic_grad_norm": global_norm(gc),
                "explained_var": explained_var,
                "approx_kl": torch.mean(ratio - 1.0 - torch.log(ratio)),
            }

    @torch.no_grad()
    def _update_joint_direct(
        self, ts: MAPPOState, mb: Dict[str, torch.Tensor], stop=None
    ) -> Dict[str, torch.Tensor]:
        """One minibatch with the loss's gradients from the forward kernel
        (mappo.py:1048-1157): `pair_ppo_grads_fwdloss` ("fwdloss") or
        `pair_ppo_grads` ("agrad") give the encoder gradients, the policy
        term of dlog_std and the stats' column sums; the entropy bonus adds
        -entropy_coef to dlog_std (the Gaussian's entropy does not depend on
        the state).  Then `_step`; the metrics come from the sums."""
        cfg = self.cfg
        a_dim = self.action_dim
        x = mb["obs_rows"]
        s = x.shape[0]
        loss = PPOLossCfg(clip_param=cfg.clip_param, huber_delta=cfg.huber_delta,
                          action_dim=a_dim, n_rows=s)
        grads_fn = pair_ppo_grads if cfg.direct_mode == "agrad" else pair_ppo_grads_fwdloss
        dla, dls, dlc, sums = grads_fn(
            ts.actor.spec, ts.critic.spec, loss, ts.actor.leaves, ts.critic.leaves,
            ts.log_std, x, mb["action"].reshape(s, a_dim), mb["logp"].reshape(s, 1),
            mb["advantages"].reshape(s, 1), mb["value"].reshape(s, 1),
            mb["returns"].reshape(s, 1))
        ga = [torch.cat([g.reshape(-1) for g in dla]), dls - self._entropy_coef(ts)]
        gc = [torch.cat([g.reshape(-1) for g in dlc])]
        inv_s = 1.0 / s
        ret_var = sums[_SUM_RET2] * inv_s - torch.square(sums[_SUM_RET] * inv_s)
        info = {
            "policy_loss": -(a_dim * inv_s) * sums[_SUM_MIN12],
            "actor_grad_norm": global_norm(ga),
            "entropy": _gaussian_entropy(ts.log_std),
            "ESS": torch.square(sums[_SUM_RATIO]) / (sums[_SUM_RATIO2] * s),
            "value_loss": torch.maximum(sums[_SUM_H1] * inv_s, sums[_SUM_H2] * inv_s),
            "critic_grad_norm": global_norm(gc),
            "explained_var": 1.0 - (sums[_SUM_SQERR] * inv_s) / (ret_var + 1e-8),
            # the k3 estimator from the sums
            "approx_kl": (sums[_SUM_RATIO] - s - sums[_SUM_LOGR]) * inv_s,
        }
        self._step(ts, ga, gc, stop)
        return info

    def _update_actor(self, ts: MAPPOState, mb: Dict[str, torch.Tensor], stop=None):
        """The flat actor's step (mappo.py:809-853): PPO-clip on [m, n, 1]
        samples with `entropy_loss = -mean(entropy)`, then clip + Adam."""
        cfg = self.cfg
        with torch.enable_grad():
            mean = ts.actor(mb["obs"])
            log_std = ts.log_std.detach().requires_grad_(True)
            dist = Gaussian(mean=mean, log_std=log_std.expand(mean.shape))
            logp_new = dist.log_prob(mb["action"])[..., None]
            entropy = dist.entropy()[..., None]
            ratio = torch.exp(torch.clamp(logp_new - mb["logp"], -20.0, 20.0))
            adv = mb["advantages"]
            surr1 = ratio * adv
            surr2 = torch.clamp(ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param) * adv
            policy_loss = -torch.mean(torch.minimum(surr1, surr2) * self.action_dim)
            entropy_loss = -torch.mean(entropy)
            total = policy_loss + entropy_loss * self._entropy_coef(ts)
            ga = list(torch.autograd.grad(total, [ts.actor.flat, log_std]))
        self._actor_step(ts, ga, stop)
        with torch.no_grad():
            w = ratio.detach().reshape(-1)
            return {
                "policy_loss": policy_loss.detach(),
                "actor_grad_norm": global_norm(ga),
                "entropy": -entropy_loss.detach(),
                "ESS": torch.square(torch.sum(w)) / (torch.sum(torch.square(w)) * w.shape[0]),
                "approx_kl": torch.mean(w - 1.0 - torch.log(w)),
            }

    def _update_critic(self, ts: MAPPOState, mb: Dict[str, torch.Tensor], stop=None):
        """The flat critic's step (mappo.py:1160-1196): the max of the two
        Huber means (plain and clipped values), then clip + Adam(W)."""
        cfg = self.cfg
        b_values, b_returns = mb["value"], mb["returns"]
        with torch.enable_grad():
            values = ts.critic(mb["obs"])
            clipped = b_values + torch.clamp(values - b_values, -cfg.clip_param, cfg.clip_param)
            loss = torch.maximum(_huber(values, b_returns, cfg.huber_delta),
                                 _huber(clipped, b_returns, cfg.huber_delta))
            gc = list(torch.autograd.grad(loss, [ts.critic.flat]))
        self._critic_step(ts, gc, stop)
        with torch.no_grad():
            values = values.detach()
            explained_var = 1.0 - torch.mean(torch.square(values - b_returns)) / (
                torch.var(b_returns, correction=0) + 1e-8)
            return {"value_loss": loss.detach(), "critic_grad_norm": global_norm(gc),
                    "explained_var": explained_var}

    def _update_actor_critic(self, ts: MAPPOState, mb: Dict[str, torch.Tensor], stop=None):
        """One minibatch of the flat path: `_update_actor`, then
        `_update_critic` (the JAX package's non-joint branch)."""
        return {**self._update_actor(ts, mb, stop), **self._update_critic(ts, mb, stop)}

    def _update_tp(self, ts: MAPPOState, traj: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The TP net's supervised epochs (mappo.py:1197-1270): every window
        of `future_prediction_step` future evader positions, masked where an
        episode ends inside it or `tp_done` is unset; plain Adam, no clip.
        The forward is the TP kernel and its backward the TP backward kernel
        (autograd Function under `tp_forward`)."""
        cfg = self.cfg
        w = cfg.future_prediction_step
        tp_gt, tp_input = traj["tp_gt"], traj["tp_input"]
        t_len = tp_gt.shape[0]
        n_windows = t_len - w
        dev = tp_gt.device
        idx = (torch.arange(n_windows, device=dev)[:, None]
               + torch.arange(1, w + 1, device=dev)[None, :])
        windows = tp_gt[idx].transpose(1, 2)                # [W, E, w, 3]
        targets = windows.reshape(windows.shape[:2] + (w * 3,))
        inputs = tp_input[:n_windows]                        # [W, E, H, F]
        win_done = traj["done"][..., 0].to(torch.bool)[idx]  # [W, w, E]
        valid = (~torch.any(win_done, dim=1)) & traj["tp_done"][:n_windows, :, 0].to(torch.bool)
        valid = valid.to(torch.float32)[..., None]           # [W, E, 1]
        flat_in = inputs.reshape((-1,) + tuple(inputs.shape[2:]))
        net = ts.tp_net
        losses = []
        for _ in range(cfg.tp_epochs):
            with torch.enable_grad():
                pred = net(flat_in).reshape(targets.shape)
                se = torch.square(pred - targets) * valid
                loss = torch.sum(se) / (torch.sum(valid) * targets.shape[-1] + 1e-8)
                grads = torch.autograd.grad(loss, list(net.leaves()))
            with torch.no_grad():
                upd, opt = adam_updates(grads, ts.tp_opt, cfg.tp_lr)
                new = [p + u for p, u in zip(net.leaves(), upd)]
                self._write(list(net.leaves()), new, ts.tp_opt, opt, None)
            losses.append(loss.detach())
        return {"TP_loss": torch.mean(torch.stack(losses))}
