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
`pair_ppo_grads`).  On a card without ranks each joint minibatch replays as
one CUDA graph (`_minibatch`, `utils/graphs.py`).

Over flat observations ([..., n, D], Hover's) the actor and the critic are
`FlatHeadNet`s (LayerNorm + MLP in `compute_dtype`, float32 heads) in plain
torch, as in the JAX package, whose flat path runs no kernel; `train_op`
takes JAX's non-joint branch: per minibatch `_update_actor`, then
`_update_critic`, each with its own loss, clip and Adam step.

The non-joint branch also takes every configuration where JAX's `use_joint`
is false (mappo.py:728-749): per-agent actors (`share_actor=False`, an
`AgentStack` of one network an agent, whose parameters form one optimizer
group: one clip over all of them), the centralized critic
(`critic_input="state"`: one network of `n_agents` outputs over the env's
critic state), the relation encoders (`RelationHeadNet`, plain torch, as
plain XLA in the JAX package) and injected networks (`actor_module` /
`critic_module`: the PPO family's).  A `PartialAttentionEncoder` network
there is an `EncoderHead` and runs the encoder kernels (`encoder_forward`,
its backward under autograd) on CUDA tensors, one launch a network: an
agent's actor on that agent's rows, the critic, the state critic.

Across ranks (`train_op(..., shard=)`, `mupe_tpu_torch/parallel`) every
rank holds its arenas' rows of the trajectory and computes the one-rank
update: the advantage statistics and the value normaliser's moments are
global, a minibatch is the rows of the global permutation this rank owns,
every mean divides by the global count, the clipped Huber's branch and the
metrics come from sums over the ranks, and each step's gradients are summed
over the ranks before the clip and Adam, so every rank applies the same
bits.  A rank that owns no row of a minibatch joins its collectives with
zeros and launches no kernel.
"""
from __future__ import annotations

import dataclasses
import functools
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
from ..parallel import dist
from ..utils import graphs, trace
from .modules.distributions import Gaussian
from .modules.networks import (
    FlatHeadNet,
    RelationHeadNet,
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
ENCODERS = ("PartialAttentionEncoder", "RelationEncoder", "PartialRelationEncoder")
CRITIC_INPUTS = ("obs", "state")
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

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """[..., k, d] groups → [..., head_dim]: one `encoder_forward`
        launch on CUDA tensors (the plain version on CPU ones)."""
        names = entity_group_order(obs.keys())
        x, lead = pack_obs(self.spec, obs, names)
        return encoder_forward(self.spec, self.leaves, x).reshape(lead + (self.spec.head_dim,))


def tree_map(fn, tree):
    """`fn` on every tensor of a tensor or a (nested) dict of them."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def agent_slice(obs, i: int, axis: int):
    """Agent i's observation: index `axis` of every leaf."""
    return tree_map(lambda x: x.select(x.dim() + axis, i), obs)


class AgentStack(nn.Module):
    """Per-agent networks (`share_actor=False`, the JAX package's stacked
    parameters vmapped over the agent axis, mappo.py:539-547): network i
    reads agent i's observation (axis -3 of dict leaves [..., n, k, d], -2
    of flat ones [..., n, D]); the outputs stack on axis -2."""

    def __init__(self, nets: Sequence[nn.Module], agent_axis: int):
        super().__init__()
        self.nets = nn.ModuleList(nets)
        self.agent_axis = agent_axis

    def flats(self) -> List[torch.Tensor]:
        return [net.flat for net in self.nets]

    def forward(self, obs) -> torch.Tensor:
        return torch.stack([net(agent_slice(obs, i, self.agent_axis))
                            for i, net in enumerate(self.nets)], dim=-2)


def net_flats(net: nn.Module) -> List[torch.Tensor]:
    """A network's flat parameter vectors: one, or one an agent."""
    return net.flats() if isinstance(net, AgentStack) else [net.flat]


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
    flat ones, `RelationHeadNet`s, the PPO family's `LeafNet`s, or (per-agent
    actors) an `AgentStack` of them."""

    actor: nn.Module
    log_std: torch.Tensor          # [A], or [n, A] for per-agent actors
    critic: nn.Module
    tp_net: Optional[TPNet] = None
    actor_opt: Optional[AdamState] = None   # over [actor flat(s), log_std]
    critic_opt: Optional[AdamState] = None  # over [critic.flat]
    tp_opt: Optional[AdamState] = None      # over the TP net's five leaves
    value_norm: Optional[ValueNorm1] = None
    entropy_coef: Optional[torch.Tensor] = None

    def actor_params(self) -> List[torch.Tensor]:
        return [*net_flats(self.actor), self.log_std]

    def critic_params(self) -> List[torch.Tensor]:
        return net_flats(self.critic)


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


def _huber_sum(pred, target, delta):
    """sum of optax.huber_loss."""
    abs_err = torch.abs(pred - target)
    quadratic = torch.minimum(abs_err, torch.full_like(abs_err, delta))
    linear = abs_err - quadratic
    return torch.sum(0.5 * quadratic ** 2 + delta * linear)


def _ppo_clip(cfg, logp_new, logp_old, adv, action_dim: int, n):
    """The PPO-clip surrogate over `n` samples (every rank's): (ratio,
    policy_loss), the log-ratio clamped to +-20 before the exp and the
    surrogate scaled by the action's width, as the JAX package does."""
    ratio = torch.exp(torch.clamp(logp_new - logp_old, -20.0, 20.0))
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param) * adv
    return ratio, -torch.sum(torch.minimum(surr1, surr2) * action_dim) / n


def _clipped_huber(cfg, values, old_values, returns, n):
    """The two Huber means over `n` samples of the value loss: (h1, h2), of
    the values and of the values clipped to +-clip_param about the old ones;
    the loss is their max (`_max_branch`)."""
    clipped = old_values + torch.clamp(values - old_values, -cfg.clip_param, cfg.clip_param)
    return (_huber_sum(values, returns, cfg.huber_delta) / n,
            _huber_sum(clipped, returns, cfg.huber_delta) / n)


def _info_metrics(n, ratio_sums=None, value_sums=None) -> Dict[str, torch.Tensor]:
    """The info metrics of `n` samples from statistics summed over every
    rank: `ratio_sums` (sum ratio, sum ratio^2, sum of ratio - 1 - log ratio)
    give ESS and approx_kl (the k3 estimator); `value_sums` (the Huber
    means h1, h2, sum (value - return)^2, sum return, sum return^2) give
    value_loss and explained_var."""
    out = {}
    if ratio_sums is not None:
        ratio, ratio2, kl = ratio_sums
        out.update(ESS=torch.square(ratio) / (ratio2 * n), approx_kl=kl / n)
    if value_sums is not None:
        h1, h2, sqerr, ret, ret2 = value_sums
        ret_var = ret2 / n - torch.square(ret / n)
        out.update(value_loss=torch.maximum(h1, h2),
                   explained_var=1.0 - (sqerr / n) / (ret_var + 1e-8))
    return out


def _max_branch(h1, h2, g1, g2):
    """max(H1, H2) of two batch means whose values over every rank are g1,
    g2: the branch the global values choose, differentiable in this rank's
    share (an even split on a tie, as `torch.maximum`'s gradient)."""
    return torch.where(g1 > g2, h1, torch.where(g2 > g1, h2, 0.5 * (h1 + h2)))


def _syncs_batch_stats(net) -> bool:
    """Whether `net`'s forward and backward hold collectives (MobileNet's
    batch statistics across ranks): then a rank without rows of a
    minibatch runs them on its empty rows, where it would join with zeros."""
    return bool(getattr(net, "batch_stats", False))


def local_minibatches(mb_idx: torch.Tensor, e_local: int, shard) -> List[torch.Tensor]:
    """This rank's rows of each minibatch of global row indices [M, B]
    (row t*E + e of the [T*E] global layout), as indices into its own
    [T*E_local] rows (t*E_local + e - offset), in the permutation's order.
    One host read an epoch."""
    if shard is None or shard.full:
        return list(mb_idx)
    env = mb_idx % shard.total
    own = (env >= shard.offset) & (env < shard.offset + shard.size)
    local = (mb_idx // shard.total) * e_local + (env - shard.offset)
    with trace.span("sync.minibatch_counts"):
        counts = torch.sum(own, dim=1).tolist()
        return list(torch.split(local[own], counts))


class MAPPOPolicy:
    """Static algorithm object; methods are functions of a `MAPPOState`.

    `actor_module` / `critic_module` inject the networks (the JAX package's
    `MAPPOPolicy(actor_module=, critic_module=)`, mappo.py:298-335): each a
    callable `(example observation, leaves=None, generator=None) -> LeafNet`
    whose actor returns the Gaussian's mean (its log_std is the state's) and
    whose critic returns values [..., n, 1]."""

    def __init__(
        self,
        cfg: MAPPOCfg,
        n_agents: int,
        action_dim: int,
        obs_is_dict: bool,
        tp_input_dim: Optional[int] = None,
        device: torch.device | str = "cuda",
        tp_history_step: int = 10,
        actor_module: Optional[Callable[..., nn.Module]] = None,
        critic_module: Optional[Callable[..., nn.Module]] = None,
    ):
        if cfg.critic_input not in CRITIC_INPUTS:
            raise ValueError(f"critic_input {cfg.critic_input!r} is not one of {CRITIC_INPUTS}")
        if cfg.attn_encoder not in ENCODERS:
            raise KeyError(f"attn_encoder {cfg.attn_encoder!r} is not one of {ENCODERS}")
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
        self.actor_module, self.critic_module = actor_module, critic_module
        self._default_modules = actor_module is None and critic_module is None
        # the agent axis of per-agent observations (mappo.py:544)
        self.agent_axis = -3 if obs_is_dict else -2
        self._act_graph = graphs.Graphed()
        self._update_graph = graphs.Graphed()

    def specs(self, obs: Dict[str, torch.Tensor]):
        """(group names, actor spec, critic spec) for a dict observation
        with leaves [..., k, d]."""
        self._check_entity_groups(obs)
        names = entity_group_order(obs.keys())
        groups = tuple((obs[n].shape[-2], obs[n].shape[-1]) for n in names)
        return (names, EncoderSpec(groups=groups, head_dim=self.action_dim),
                EncoderSpec(groups=groups, head_dim=1))

    @staticmethod
    def _check_entity_groups(obs) -> None:
        other = [k for k in obs if k in _NON_ENTITY_KEYS]
        if other:
            raise ValueError(
                f"MAPPO's default networks cannot train dict observations with the branches "
                f"{other} (Hover with dr_* ranges, obs_history_len or obs_depth), and the JAX "
                "package's MAPPO fails on them too: train them with algo=ppo_adapt (intrinsics "
                "and observation_h), algo=ppo_vision (depth), algo=ppo with priv_actor / "
                "priv_critic, or algo=ppo_tconv")

    def joint(self, obs) -> bool:
        """Whether the joint actor+critic update and the pair forward apply:
        the JAX package's `_fused_ok` with a per-agent critic, its
        `use_joint` (mappo.py:442-451, 728-730)."""
        return (self.cfg.share_actor and self.obs_is_dict and isinstance(obs, dict)
                and self.cfg.attn_encoder == "PartialAttentionEncoder"
                and self._default_modules and self.cfg.critic_input == "obs")

    def _check_state(self, state) -> None:
        """The centralized critic's input must be a well-formed state: a
        dict of entity groups that share their rank (tokens on axis -2)."""
        if len({v.dim() for v in state.values()}) > 1:
            shapes = {k: tuple(v.shape) for k, v in state.items()}
            raise ValueError(
                f"critic_input='state' needs state groups of one rank, got {shapes}: their "
                "tokens cannot be concatenated (the JAX package's SplitEmbedding fails on this "
                "state at init_carry too; HideAndSeek's per-drone cylinders are [E, n, k, 5])")

    def _make_net(self, role: str, example, leaves, generator) -> nn.Module:
        """One network of `role` ("actor" or "critic") for `example` (an
        observation, an agent's observation, or the critic state)."""
        module = self.actor_module if role == "actor" else self.critic_module
        if module is not None:
            return module(example, leaves=leaves, generator=generator)
        state = role == "critic" and self.cfg.critic_input == "state"
        out = self.action_dim if role == "actor" else (self.n_agents if state else 1)
        if state or self.obs_is_dict:
            if not state:
                self._check_entity_groups(example)
            names = entity_group_order(example.keys())
            if self.cfg.attn_encoder == "PartialAttentionEncoder":
                spec = EncoderSpec(groups=tuple((example[n].shape[-2], example[n].shape[-1])
                                                for n in names), head_dim=out)
                if leaves is None:
                    leaves = init_encoder_leaves(spec, role, generator)
                return EncoderHead(spec, leaves)
            groups = {n: (example[n].shape[-2], example[n].shape[-1]) for n in names}
            return RelationHeadNet(self.cfg.attn_encoder, groups, out, role, self.compute_dtype,
                                   leaves, generator)
        d, hidden = example.shape[-1], self.cfg.hidden_units
        if leaves is None:
            leaves = init_flat_leaves(d, hidden, out, role, generator)
        return FlatHeadNet(d, hidden, out, self.compute_dtype, leaves)

    def init_tp(self, generator: Optional[torch.Generator] = None, tp_leaves=None):
        """The TP net alone (needed before the first observation, of which
        its prediction is a part), or None without it."""
        if not self.cfg.use_tp_net:
            return None
        return TPNet(self.tp_input_dim, 3 * self.cfg.future_prediction_step,
                     history_step=self.tp_history_step, leaves=tp_leaves, generator=generator,
                     device=self.device)

    def init(
        self,
        obs_example,
        generator: Optional[torch.Generator] = None,
        actor_leaves=None,
        log_std=None,
        critic_leaves=None,
        tp_leaves=None,
        state_example=None,
    ) -> MAPPOState:
        """Parameters from given leaves (e.g. converted by `bridge`) or, for
        any not given, initialised from `generator` (a CPU generator).
        `obs_example` is a dict of entity groups, or a flat [..., n, D]
        observation; per-agent actors take one leaf list an agent
        (`actor_leaves[i]`) and a log_std [n, A].  The centralized critic
        (`critic_input="state"`) is built over `state_example`, which must be
        given and well formed."""
        cfg = self.cfg
        if cfg.critic_input == "state":
            if state_example is None:
                raise ValueError("critic_input='state' needs the env's critic state "
                                 "(state_example); this env provides none")
            self._check_state(state_example)
        if cfg.share_actor:
            actor = self._make_net("actor", obs_example, actor_leaves, generator)
            ls_shape = (self.action_dim,)
        else:
            # every agent's network from the same shapes (mappo.py:379-382)
            one = agent_slice(obs_example, 0, self.agent_axis)
            actor = AgentStack([self._make_net("actor", one, None if actor_leaves is None
                                               else actor_leaves[i], generator)
                                for i in range(self.n_agents)], self.agent_axis)
            ls_shape = (self.n_agents, self.action_dim)
        critic = self._make_net("critic", state_example if cfg.critic_input == "state"
                                else obs_example, critic_leaves, generator)
        if log_std is None:
            log_std = torch.zeros(ls_shape)
        ts = MAPPOState(
            actor=actor.to(self.device),
            log_std=torch.as_tensor(log_std, dtype=torch.float32).clone().to(self.device),
            critic=critic.to(self.device),
            tp_net=self.init_tp(generator, tp_leaves),
            value_norm=ValueNorm1.create((1,), beta=cfg.value_norm_beta, device=self.device),
        )
        ts.actor_opt = AdamState.zeros_like(ts.actor_params())
        ts.critic_opt = AdamState.zeros_like(ts.critic_params())
        if ts.tp_net is not None:
            ts.tp_opt = AdamState.zeros_like(list(ts.tp_net.leaves()))
        if cfg.entropy_target is not None:
            ts.entropy_coef = torch.tensor(cfg.entropy_coef, device=self.device)
        return ts

    def _values(self, ts: MAPPOState, obs, state=None) -> torch.Tensor:
        """V per agent → [..., n, 1], differentiable in the critic."""
        if self.cfg.critic_input == "state":
            return ts.critic(state)[..., None]
        return ts.critic(obs)

    @torch.no_grad()
    def value_op(self, ts: MAPPOState, obs, state=None) -> torch.Tensor:
        """V(s) per agent → [..., n, 1] (the critic alone: `encoder_forward`,
        or the flat critic; over `state` for the centralized critic)."""
        return self._values(ts, obs, state)

    @torch.no_grad()
    def act(
        self,
        ts: MAPPOState,
        obs,
        generator: Optional[torch.Generator] = None,
        deterministic: bool = False,
        noise: Optional[torch.Tensor] = None,
        state=None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Sample actions → (action, logp [..., n, 1], value [..., n, 1]).
        Where the joint update applies, actor and critic run in one
        `encoder_pair_forward` launch.  `noise` (standard normal, the
        action's shape) replaces the generator's draw; `state` is the
        centralized critic's input.  With the policy's own networks the
        whole call replays as a CUDA graph on a card (`utils/graphs.py`),
        keyed by the parameters' storage; injected networks (the PPO
        family's) run eagerly."""
        run = functools.partial(self._act, ts, deterministic)
        if not self._default_modules:
            return run(generator, obs, noise, state)
        reads = [ts.log_std, *ts.actor.parameters(), *ts.actor.buffers(),
                 *ts.critic.parameters(), *ts.critic.buffers()]
        draws = not deterministic and noise is None
        return self._act_graph(run, obs, noise, state, reads=reads, flags=(deterministic,),
                               generators=(generator if draws else None,))

    def _act(self, ts: MAPPOState, deterministic: bool, generator, obs, noise, state):
        if self.joint(obs):
            names, spec_a, spec_c = self.specs(obs)
            x, lead = pack_obs(spec_a, obs, names)
            mean, value = encoder_pair_forward(
                spec_a, spec_c, list(ts.actor.leaves), list(ts.critic.leaves), x
            )
            mean = mean.reshape(lead + (self.action_dim,))
            value = value.reshape(lead + (1,))
        else:
            mean, value = ts.actor(obs), self._values(ts, obs, state)
        dist = Gaussian(mean=mean, log_std=ts.log_std.expand(mean.shape))
        action = dist.mode if deterministic else dist.sample(generator, noise)
        return action, dist.log_prob(action)[..., None], value

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
        last_state=None,
        shard=None,
    ) -> Tuple[MAPPOState, Dict[str, torch.Tensor]]:
        """The update (mappo.py:593-806) on a rollout's trajectory: bootstrap
        value, flat GAE + advantage normalisation + `ValueNorm1`, the TP
        net's supervised step, then `ppo_epochs` x `num_minibatches` joint
        actor+critic steps (`_update_joint_flat`, or `_update_joint_direct`
        with `use_inkernel_loss`), or where the joint update does not apply
        an actor step and a critic step (`_update_actor_critic`), whose
        minibatches also gather `traj["state"]` for the centralized critic
        (`last_state` is its bootstrap input).  Minibatches are drawn
        from `perms` ([ppo_epochs, T*E] permutations, e.g. the JAX package's) or from
        `generator`.  Metrics stay device tensors (no host sync).  `mark`,
        if given, is called with "prep", "tp" and "ppo" as each phase ends
        (a timer may synchronise there).  `shard` (an `EnvShard`) says which
        arenas of the global rollout `traj` holds; the update is then the
        one-rank update of every rank's rows (the module's docstring)."""
        cfg = self.cfg
        t_len, e, n_ag = traj["reward"].shape[:3]
        e_total = e if shard is None else shard.total
        with torch.no_grad(), trace.span("update.prep"):
            next_value = self.value_op(ts, last_obs, last_state)
            values = ts.value_norm.denormalize(traj["value"].reshape(t_len, e * n_ag))
            next_value = ts.value_norm.denormalize(next_value.reshape(e * n_ag))
            reward = traj["reward"].reshape(t_len, e * n_ag)
            done = traj["done"][:, :, None, 0].expand(t_len, e, n_ag).reshape(t_len, e * n_ag)
            advantages, returns = compute_gae(reward, done, values, next_value,
                                              cfg.gamma, cfg.gae_lambda)
            # two passes over every rank's advantages
            count = t_len * e_total * n_ag
            adv_mean = dist.global_sum(advantages) / count
            adv_std = torch.sqrt(dist.global_sum(torch.square(advantages - adv_mean)) / count)
            if cfg.normalize_advantages:
                advantages = (advantages - adv_mean) / (adv_std + 1e-8)
            ts.value_norm = ts.value_norm.update(returns[..., None])
            returns = ts.value_norm.normalize(returns)
            if self.joint(last_obs):
                meta = compute_pack_meta(last_obs, self.n_agents, self.action_dim)
                packed = pack_rows(meta, traj["obs"], traj["action"], traj["logp"],
                                   traj["value"], advantages, returns)

                def minibatch(idx):
                    return unpack_rows(meta, packed[idx])

                update = (self._update_joint_direct if cfg.use_inkernel_loss
                          else self._update_joint_flat)
            else:
                # the JAX package's non-joint layout: [T*E, ...] per field,
                # dict observations and states gathered leaf by leaf
                fields = {"obs": traj["obs"], "action": traj["action"], "logp": traj["logp"],
                          "value": traj["value"],
                          "advantages": advantages.reshape(t_len, e, n_ag, 1),
                          "returns": returns.reshape(t_len, e, n_ag, 1)}
                if cfg.critic_input == "state":
                    fields["state"] = traj["state"]
                fields = tree_map(lambda v: v.reshape((t_len * e,) + tuple(v.shape[2:])), fields)

                def minibatch(idx):
                    return tree_map(lambda v: v[idx], fields)

                update = self._update_actor_critic
        mark = mark or (lambda name: None)
        mark("prep")
        metrics: Dict[str, torch.Tensor] = {"advantages_mean": adv_mean,
                                            "advantages_std": adv_std}
        if ts.tp_net is not None and "tp_input" in traj:
            with trace.span("update.tp"):
                metrics.update(self._update_tp(ts, traj))
        mark("tp")

        with trace.span("update.ppo"):
            b = t_len * e_total
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
                mb_idx = perm[: mb_size * cfg.num_minibatches].reshape(cfg.num_minibatches,
                                                                       mb_size)
                for idx in local_minibatches(mb_idx, e, shard):
                    info = update(ts, minibatch(idx), stop, mb_rows=mb_size)
                    if stop is not None:
                        stop = torch.logical_or(stop, info["approx_kl"] > cfg.target_kl)
                        info["kl_stop"] = stop.to(torch.float32)
                    for k, v in info.items():
                        infos.setdefault(k, []).append(v)
            with torch.no_grad():
                metrics.update({k: torch.mean(torch.stack(v)) for k, v in infos.items()})
                if cfg.entropy_target is not None:
                    err = cfg.entropy_target - metrics["entropy"]
                    err = torch.sign(err) * torch.clamp(torch.abs(err) - cfg.entropy_deadband,
                                                        min=0.0)
                    err = torch.clamp(err, -cfg.entropy_err_clip, cfg.entropy_err_clip)
                    # in place: the graphed minibatch reads it by its storage
                    ts.entropy_coef.copy_(torch.clamp(
                        ts.entropy_coef * torch.exp(cfg.entropy_adapt_speed * err),
                        cfg.entropy_coef_min, cfg.entropy_coef_max))
                    metrics["entropy_coef"] = ts.entropy_coef.clone()
                metrics["action_norm"] = dist.global_sum(
                    torch.linalg.vector_norm(traj["action"], dim=-1)) / count
                metrics["value_running_mean"] = torch.mean(ts.value_norm.running_mean)
        mark("ppo")
        return ts, metrics

    def _count(self, mb: Dict[str, torch.Tensor], mb_rows: Optional[int]) -> int:
        """The minibatch's sample count over every rank (agents included):
        the means' normaliser.  `mb_rows` is the global minibatch's rows,
        or None for this minibatch alone."""
        if mb_rows is None:
            return int(mb["logp"].numel())
        return mb_rows * self.n_agents

    def _joint_grads(self, ts: MAPPOState, mb: Dict[str, torch.Tensor],
                     mb_rows: Optional[int] = None):
        """The joint loss of `_update_joint_flat` (mappo.py:974-1012) and its
        gradients: the pair forward (one kernel launch), the PPO-clip +
        clipped-Huber loss on flat [s] vectors in plain torch, and the pair
        backward (one kernel launch, through the autograd Function).  Every
        mean divides by the global count, the Huber branch is chosen from
        the sums over the ranks, and the gradients are summed over the ranks;
        the entropy bonus's gradient (-entropy_coef on log_std, whatever the
        rows) is added after the sum.  Returns ([d actor.flat, d log_std],
        [d critic.flat], the terms over every rank: the info metrics but the
        gradient norms, `sums` of ratio, ratio^2, k3, squared error, return
        and return^2, and `count`)."""
        cfg = self.cfg
        act, logp_old, adv = mb["action"], mb["logp"], mb["advantages"]
        b_values, b_returns = mb["value"], mb["returns"]
        count = self._count(mb, mb_rows)
        params = [ts.actor.flat, ts.log_std, ts.critic.flat]
        if logp_old.shape[0] == 0:
            # no row of this minibatch here: zeros into every collective
            grads = [torch.zeros_like(p) for p in params]
            local = torch.zeros(9, device=ts.log_std.device)
            glob = dist.all_reduce_sum(local)
        else:
            with torch.enable_grad():
                mean, values = encoder_pair_forward(ts.actor.spec, ts.critic.spec,
                                                    ts.actor.leaves, ts.critic.leaves,
                                                    mb["obs_rows"])
                values = values[:, 0]
                log_std = ts.log_std.detach().requires_grad_(True)
                z = (act - mean) * torch.exp(-log_std)
                logp_new = torch.sum(-0.5 * torch.square(z) - log_std - _LOG_SQRT_2PI, dim=-1)
                ratio, policy_loss = _ppo_clip(cfg, logp_new, logp_old, adv, self.action_dim,
                                               count)
                h1, h2 = _clipped_huber(cfg, values, b_values, b_returns, count)
                with torch.no_grad():
                    r, v = ratio.detach(), values.detach()
                    local = torch.stack([
                        policy_loss.detach(), h1.detach(), h2.detach(), torch.sum(r),
                        torch.sum(torch.square(r)), torch.sum(r - 1.0 - torch.log(r)),
                        torch.sum(torch.square(v - b_returns)), torch.sum(b_returns),
                        torch.sum(torch.square(b_returns))])
                    glob = dist.all_reduce_sum(local)
                total = policy_loss + _max_branch(h1, h2, glob[1], glob[2])
                grads = list(torch.autograd.grad(total, [ts.actor.flat, log_std,
                                                         ts.critic.flat]))
        grads = dist.all_reduce_tensors(grads)
        with torch.no_grad():
            grads[1] = grads[1] - self._entropy_coef(ts)   # d(-coef * entropy) / d log_std
        terms = dict(policy_loss=glob[0], entropy=_gaussian_entropy(ts.log_std.detach()),
                     **_info_metrics(count, glob[3:6], (glob[1], glob[2], *glob[6:])),
                     sums=glob[3:], count=count)
        return grads[:2], grads[2:], terms

    def _actor_step(self, ts: MAPPOState, ga, stop) -> None:
        """Clip + Adam for the actor (log_std in its global norm, then its
        floor), written into `ts` (held where `stop` is set)."""
        cfg = self.cfg
        with torch.no_grad():
            upd, opt = adam_updates(clip_by_global_norm(ga, cfg.max_grad_norm),
                                    ts.actor_opt, cfg.actor_lr)
            new = [p + u for p, u in zip(ts.actor_params(), upd)]
            new[-1] = self._apply_log_std_floor(new[-1])
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

    def _minibatch(self, step: Callable, ts: MAPPOState, mb: Dict[str, torch.Tensor], stop,
                   mb_rows: Optional[int]) -> Dict[str, torch.Tensor]:
        """One joint minibatch, `step(ts, mb_rows, mb, stop)`, with grad
        disabled (the step enables it where it differentiates).  On a card
        without ranks the call replays as one CUDA graph (`utils/graphs.py`):
        the parameters, Adam's states and the adaptive entropy coefficient
        are its `reads`, written in place, and the minibatch's rows and
        `stop` are copied in, so one graph serves every minibatch of every
        iteration; a key's first call is the real step, eager.  With ranks
        it runs eagerly: the minibatches' rows, counted on the host, differ
        by rank, and their collectives stay outside any graph."""
        run = functools.partial(step, ts, mb_rows)
        with torch.no_grad():
            if dist.is_initialized():
                return run(mb, stop)
            reads = [*ts.actor_params(), *ts.critic_params(), *ts.actor_opt.tensors(),
                     *ts.critic_opt.tensors()]
            if ts.entropy_coef is not None:
                reads.append(ts.entropy_coef)
            return self._update_graph(run, mb, stop, reads=reads,
                                      flags=(step.__name__, mb_rows))

    def _update_joint_flat(
        self, ts: MAPPOState, mb: Dict[str, torch.Tensor], stop=None,
        mb_rows: Optional[int] = None,
    ) -> Dict[str, torch.Tensor]:
        """One minibatch (mappo.py:949-1045): `_joint_grads`, then clip +
        Adam for the actor (log_std in its global norm) and the critic;
        returns the info metrics, from sums over every rank.  One CUDA graph
        on a card (`_minibatch`)."""
        return self._minibatch(self._joint_flat_step, ts, mb, stop, mb_rows)

    def _joint_flat_step(self, ts: MAPPOState, mb_rows: Optional[int],
                         mb: Dict[str, torch.Tensor], stop) -> Dict[str, torch.Tensor]:
        ga, gc, terms = self._joint_grads(ts, mb, mb_rows)
        self._step(ts, ga, gc, stop)
        with torch.no_grad():
            info = {k: v for k, v in terms.items() if k not in ("sums", "count")}
            return dict(info, actor_grad_norm=global_norm(ga), critic_grad_norm=global_norm(gc))

    def _update_joint_direct(
        self, ts: MAPPOState, mb: Dict[str, torch.Tensor], stop=None,
        mb_rows: Optional[int] = None,
    ) -> Dict[str, torch.Tensor]:
        """One minibatch with the loss's gradients from the forward kernel
        (mappo.py:1048-1157): `pair_ppo_grads_fwdloss` ("fwdloss") or
        `pair_ppo_grads` ("agrad") give the encoder gradients, the policy
        term of dlog_std and the stats' column sums (summed over the ranks
        inside, before the value branch; the kernels' means divide by the
        global count, `PPOLossCfg.n_rows`); the entropy bonus adds
        -entropy_coef to dlog_std (the Gaussian's entropy does not depend on
        the state).  The encoder gradients are summed over the ranks, then
        `_step`; the metrics come from the sums.  One CUDA graph on a card
        (`_minibatch`)."""
        return self._minibatch(self._joint_direct_step, ts, mb, stop, mb_rows)

    def _joint_direct_step(self, ts: MAPPOState, mb_rows: Optional[int],
                           mb: Dict[str, torch.Tensor], stop) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        a_dim = self.action_dim
        x = mb["obs_rows"]
        s = x.shape[0]
        n = self._count(mb, mb_rows)
        loss = PPOLossCfg(clip_param=cfg.clip_param, huber_delta=cfg.huber_delta,
                          action_dim=a_dim, n_rows=n)
        grads_fn = pair_ppo_grads if cfg.direct_mode == "agrad" else pair_ppo_grads_fwdloss
        dla, dls, dlc, sums = grads_fn(
            ts.actor.spec, ts.critic.spec, loss, ts.actor.leaves, ts.critic.leaves,
            ts.log_std, x, mb["action"].reshape(s, a_dim), mb["logp"].reshape(s, 1),
            mb["advantages"].reshape(s, 1), mb["value"].reshape(s, 1),
            mb["returns"].reshape(s, 1))
        ga_enc, gc_enc = dist.all_reduce_tensors([torch.cat([g.reshape(-1) for g in dla]),
                                           torch.cat([g.reshape(-1) for g in dlc])])
        ga = [ga_enc, dls - self._entropy_coef(ts)]
        gc = [gc_enc]
        inv_s = 1.0 / n
        ret_var = sums[_SUM_RET2] * inv_s - torch.square(sums[_SUM_RET] * inv_s)
        info = {
            "policy_loss": -(a_dim * inv_s) * sums[_SUM_MIN12],
            "actor_grad_norm": global_norm(ga),
            "entropy": _gaussian_entropy(ts.log_std),
            "ESS": torch.square(sums[_SUM_RATIO]) / (sums[_SUM_RATIO2] * n),
            "value_loss": torch.maximum(sums[_SUM_H1] * inv_s, sums[_SUM_H2] * inv_s),
            "critic_grad_norm": global_norm(gc),
            "explained_var": 1.0 - (sums[_SUM_SQERR] * inv_s) / (ret_var + 1e-8),
            # the k3 estimator from the sums
            "approx_kl": (sums[_SUM_RATIO] - n - sums[_SUM_LOGR]) * inv_s,
        }
        self._step(ts, ga, gc, stop)
        return info

    def _update_actor(self, ts: MAPPOState, mb: Dict[str, torch.Tensor], stop=None,
                      mb_rows: Optional[int] = None):
        """The actor's step (mappo.py:809-853): PPO-clip on [m, n, 1]
        samples with `entropy_loss = -mean(entropy)`, then clip + Adam over
        every actor parameter (all agents' and log_std: one clip).  Means
        divide by the global count; the gradients and the metrics' sums are
        summed over the ranks in one collective."""
        cfg = self.cfg
        n = self._count(mb, mb_rows)
        params = ts.actor_params()
        if mb["logp"].shape[0] == 0 and not _syncs_batch_stats(ts.actor):
            ga = [torch.zeros_like(p) for p in params]
            local = torch.zeros(5, device=ts.log_std.device)
        else:
            with torch.enable_grad():
                mean = ts.actor(mb["obs"])
                log_std = ts.log_std.detach().requires_grad_(True)
                dist_ = Gaussian(mean=mean, log_std=log_std.expand(mean.shape))
                logp_new = dist_.log_prob(mb["action"])[..., None]
                entropy = dist_.entropy()[..., None]
                ratio, policy_loss = _ppo_clip(cfg, logp_new, mb["logp"], mb["advantages"],
                                               self.action_dim, n)
                entropy_loss = -torch.sum(entropy) / n
                total = policy_loss + entropy_loss * self._entropy_coef(ts)
                ga = list(torch.autograd.grad(total, [*net_flats(ts.actor), log_std]))
            with torch.no_grad():
                w = ratio.detach().reshape(-1)
                local = torch.stack([policy_loss.detach(), entropy_loss.detach(), torch.sum(w),
                                     torch.sum(torch.square(w)),
                                     torch.sum(w - 1.0 - torch.log(w))])
        *ga, glob = dist.all_reduce_tensors([*ga, local])
        self._actor_step(ts, ga, stop)
        with torch.no_grad():
            return {"policy_loss": glob[0], "actor_grad_norm": global_norm(ga),
                    "entropy": -glob[1], **_info_metrics(n, ratio_sums=glob[2:])}

    def _update_critic(self, ts: MAPPOState, mb: Dict[str, torch.Tensor], stop=None,
                       mb_rows: Optional[int] = None):
        """The critic's step (mappo.py:1160-1196): the max of the two Huber
        means (plain and clipped values), its branch chosen from the sums
        over the ranks, then clip + Adam(W) on the gradients summed over the
        ranks."""
        cfg = self.cfg
        n = self._count(mb, mb_rows)
        b_values, b_returns = mb["value"], mb["returns"]
        if b_values.shape[0] == 0 and not _syncs_batch_stats(ts.critic):
            gc = [torch.zeros_like(p) for p in ts.critic_params()]
            glob = dist.all_reduce_sum(torch.zeros(5, device=ts.log_std.device))
        else:
            with torch.enable_grad():
                values = self._values(ts, mb["obs"], mb.get("state"))
                h1, h2 = _clipped_huber(cfg, values, b_values, b_returns, n)
                with torch.no_grad():
                    v = values.detach()
                    glob = dist.all_reduce_sum(torch.stack([
                        h1.detach(), h2.detach(), torch.sum(torch.square(v - b_returns)),
                        torch.sum(b_returns), torch.sum(torch.square(b_returns))]))
                loss = _max_branch(h1, h2, glob[0], glob[1])
                gc = list(torch.autograd.grad(loss, net_flats(ts.critic)))
        gc = dist.all_reduce_tensors(gc)
        self._critic_step(ts, gc, stop)
        with torch.no_grad():
            return {**_info_metrics(n, value_sums=glob.unbind()),
                    "critic_grad_norm": global_norm(gc)}

    def _update_actor_critic(self, ts: MAPPOState, mb: Dict[str, torch.Tensor], stop=None,
                             mb_rows: Optional[int] = None):
        """One minibatch of the non-joint branch: `_update_actor`, then
        `_update_critic` (the spans `update.actor`, `update.critic`)."""
        with trace.span("update.actor"):
            info = self._update_actor(ts, mb, stop, mb_rows)
        with trace.span("update.critic"):
            return {**info, **self._update_critic(ts, mb, stop, mb_rows)}

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
        # the valid windows of every rank: the loss's normaliser
        denom = dist.global_sum(valid) * targets.shape[-1] + 1e-8
        losses = []
        for _ in range(cfg.tp_epochs):
            with torch.enable_grad():
                pred = net(flat_in).reshape(targets.shape)
                se = torch.square(pred - targets) * valid
                loss = torch.sum(se) / denom
                grads = torch.autograd.grad(loss, list(net.leaves()))
            *grads, loss = dist.all_reduce_tensors([*grads, loss.detach()])
            with torch.no_grad():
                upd, opt = adam_updates(grads, ts.tp_opt, cfg.tp_lr)
                new = [p + u for p, u in zip(net.leaves(), upd)]
                self._write(list(net.leaves()), new, ts.tp_opt, opt, None)
            losses.append(loss.detach())
        return {"TP_loss": torch.mean(torch.stack(losses))}
