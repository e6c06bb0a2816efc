"""RMA-style adaptive PPO: a privileged intrinsics encoder and an
adaptation module (counterpart of mupe_tpu/learning/ppo/ppo_adapt.py;
reference omni_drones/learning/ppo/ppo_adapt.py:144-666).

Three phases, which `harness.train_rma` chains:

  * "encoder"    PPO with the privileged context z = E(intrinsics);
  * "adaptation" the policy frozen, a TConv module A(observation history)
                 trained to reproduce z (`update_adaptation`: MSE on z, the
                 action distributions' KL, the values' deviation, both, or
                 a discriminator on the contexts, GAN or LSGAN);
  * "finetune"   acting from z^ = A(history), the policy finetuned.

The actor takes its context from `encoder` (intrinsics) in phase
"encoder" and from `adaptation` (observation_h) in the other two; the
critic always reads intrinsics through an `encoder` of its own.  The
observation features are conditioned on the context by concatenation or
FiLM (feats * (1 + gamma) + beta).  Every network is float32.  Leaves are
keyed by their flax paths (`encoder/...`, `adaptation/...`,
`_AdaptActor_0/...`, `_AdaptCritic_0/...`), and the actor's adaptation
leaves come first in its flat vector.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..mappo import MAPPOCfg, MAPPOPolicy, MAPPOState
from ..modules.distributions import DiagGaussianHead
from ..modules.networks import (
    Leaf,
    LeafNet,
    apply_dense,
    apply_ln,
    apply_mlp,
    dense_leaves,
    init_leaf,
    leaf_views,
    ln_leaves,
    mlp_leaves,
)
from ..optim import AdamState, adam_updates
from .ppo_tconv import TConvEncoder

PHASES = ("encoder", "adaptation", "finetune")
CONDITION_MODES = ("cat", "film")
ADAPTATION_LOSSES = ("mse", "action", "value", "action_value", "gan", "lsgan")
DISC_LR = 5e-4  # the discriminator's Adam (reference ppo_adapt.py:493)


@dataclasses.dataclass(frozen=True)
class PPOAdaptCfg(MAPPOCfg):
    """MAPPO's fields with ppo_adapt's own defaults (gamma 0.99, no TP net)."""

    phase: str = "encoder"        # encoder | adaptation | finetune
    context_dim: int = 64
    condition_mode: str = "cat"   # cat | film
    adaptation_loss: str = "mse"  # mse | action | value | action_value | gan | lsgan
    adaptation_lr: float = 3e-4
    gamma: float = 0.99
    use_tp_net: bool = False


class IntrinsicsEncoder(nn.Module):
    """LayerNorm -> MLP((64, context_dim)): the privileged context (JAX
    `IntrinsicsEncoder`).  Stateless, its leaves under `path`."""

    def __init__(self, path: str = "encoder", context_dim: int = 64):
        super().__init__()
        self.path, self.context_dim = path, context_dim

    def leaf_specs(self, d_intr: int) -> List[Leaf]:
        return (ln_leaves(f"{self.path}/LayerNorm_0", d_intr)
                + mlp_leaves(f"{self.path}/MLP_0", d_intr, (64, self.context_dim)))

    def forward(self, p, intrinsics: torch.Tensor) -> torch.Tensor:
        return apply_mlp(p, f"{self.path}/MLP_0",
                         apply_ln(p, f"{self.path}/LayerNorm_0", intrinsics), 2)


class AdaptationModule(nn.Module):
    """`TConvEncoder` over the observation history -> Dense(context_dim):
    the predicted context (JAX `AdaptationModule`).  Stateless, its leaves
    under `path`."""

    def __init__(self, path: str = "adaptation", context_dim: int = 64):
        super().__init__()
        self.path, self.context_dim = path, context_dim
        self.tconv = TConvEncoder(f"{path}/TConvEncoder_0")

    def leaf_specs(self, d: int, t: int) -> List[Leaf]:
        return self.tconv.leaf_specs(d, t) + dense_leaves(f"{self.path}/Dense_0", 256,
                                                          self.context_dim)

    def forward(self, p, obs_history: torch.Tensor) -> torch.Tensor:
        return apply_dense(p, f"{self.path}/Dense_0", self.tconv(p, obs_history))


class CondBody(nn.Module):
    """`MLP((128, 128))` on the observation, conditioned on the context by
    concatenation or FiLM, then `MLP((256, 256))` (JAX `_CondBody`)."""

    def __init__(self, path: str, condition_mode: str = "cat"):
        super().__init__()
        if condition_mode not in CONDITION_MODES:
            raise ValueError(f"condition_mode {condition_mode!r} is not one of {CONDITION_MODES}")
        self.path, self.film = path, condition_mode == "film"

    def leaf_specs(self, d_obs: int, context_dim: int) -> List[Leaf]:
        n = self.path
        leaves = mlp_leaves(f"{n}/MLP_0", d_obs, (128, 128))
        if self.film:
            leaves += (dense_leaves(f"{n}/Dense_0", context_dim, 128)
                       + dense_leaves(f"{n}/Dense_1", context_dim, 128))
        return leaves + mlp_leaves(f"{n}/MLP_1", 128 + (0 if self.film else context_dim),
                                   (256, 256))

    def forward(self, p, obs: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        n = self.path
        feats = apply_mlp(p, f"{n}/MLP_0", obs, 2)
        if self.film:
            x = (feats * (1.0 + apply_dense(p, f"{n}/Dense_0", context))
                 + apply_dense(p, f"{n}/Dense_1", context))
        else:
            x = torch.cat([feats, context], dim=-1)
        return apply_mlp(p, f"{n}/MLP_1", x, 2)


class AdaptBody(nn.Module):
    """`CondBody` and a head under `path`: the actor's Gaussian mean
    (`_AdaptActor_0`, its `DiagGaussianHead`) or the critic's value
    (`_AdaptCritic_0`, Dense orthogonal(0.01))."""

    def __init__(self, role: str, out_dim: int, condition_mode: str):
        super().__init__()
        self.role, self.out_dim = role, out_dim
        self.path = "_AdaptActor_0" if role == "actor" else "_AdaptCritic_0"
        self.body = CondBody(f"{self.path}/_CondBody_0", condition_mode)

    @property
    def head_path(self) -> str:
        return f"{self.path}/{DiagGaussianHead.PATH}/Dense_0" if self.role == "actor" \
            else f"{self.path}/Dense_0"

    def leaf_specs(self, d_obs: int, context_dim: int) -> List[Leaf]:
        init = "actor_head" if self.role == "actor" else "critic_head"
        return self.body.leaf_specs(d_obs, context_dim) + dense_leaves(self.head_path, 256,
                                                                       self.out_dim, init)

    def forward(self, p, obs: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        return apply_dense(p, self.head_path, self.body(p, obs, context))


def _require_keys(obs, keys) -> None:
    """The networks read these keys of a dict observation: the JAX package
    fails with KeyError on any other (HideAndSeek's entity groups, at
    init_carry)."""
    missing = [k for k in keys if not isinstance(obs, dict) or k not in obs]
    if missing:
        raise KeyError(f"ppo_adapt's networks read the observation keys {list(keys)}; this "
                       f"observation lacks {missing} (Hover with env.dr_* ranges and "
                       "env.obs_history_len provides them; the JAX package's init_carry fails "
                       "here too)")


class ContextNet(LeafNet):
    """The JAX `_ContextActorWrapper` (role "actor": the context from
    `adaptation` with `use_adaptation`, else from `encoder`, then
    `_AdaptActor_0`; returns the Gaussian's mean, its log_std being the
    policy state's) or `_ContextCriticWrapper` (role "critic": `encoder`,
    then `_AdaptCritic_0`; returns [..., 1])."""

    def __init__(self, example, out_dim: int, role: str, condition_mode: str = "cat",
                 context_dim: int = 64, use_adaptation: bool = False, leaves=None,
                 generator=None):
        super().__init__()
        self.use_adaptation = use_adaptation and role == "actor"
        _require_keys(example, ("observation",
                                "observation_h" if self.use_adaptation else "intrinsics"))
        self.context = (AdaptationModule(context_dim=context_dim) if self.use_adaptation
                        else IntrinsicsEncoder(context_dim=context_dim))
        self.head = AdaptBody(role, out_dim, condition_mode)
        if self.use_adaptation:
            h = example["observation_h"]
            ctx = self.context.leaf_specs(h.shape[-1], h.shape[-2])
        else:
            ctx = self.context.leaf_specs(example["intrinsics"].shape[-1])
        self.n_context = sum(math.prod(l.shape) for l in ctx)
        self._specs = ctx + self.head.leaf_specs(example["observation"].shape[-1], context_dim)
        self._make_flat(leaves, generator)

    def leaf_specs(self) -> List[Leaf]:
        return self._specs

    def forward(self, obs) -> torch.Tensor:
        p = self.params()
        src = obs["observation_h"] if self.use_adaptation else obs["intrinsics"]
        return self.head(p, obs["observation"], self.context(p, src))


def discriminator_specs(context_dim: int) -> List[Leaf]:
    """The leaves of JAX's `ContextDiscriminator` (the GAN and LSGAN losses'
    real / fake critic of contexts): `MLP((64, 64))` -> Dense(1)."""
    return mlp_leaves("MLP_0", context_dim, (64, 64)) + dense_leaves("Dense_0", 64, 1)


def discriminate(p, context: torch.Tensor) -> torch.Tensor:
    """Context -> real / fake logit (JAX `ContextDiscriminator`)."""
    return apply_dense(p, "Dense_0", apply_mlp(p, "MLP_0", context, 2))[..., 0]


def gaussian_kl(p_mean, p_log_std, q_mean, q_log_std) -> torch.Tensor:
    """KL(p || q) of diagonal Gaussians, summed over the action dimension."""
    var_ratio = torch.exp(2.0 * (p_log_std - q_log_std))
    t = torch.square((p_mean - q_mean) / torch.exp(q_log_std))
    return 0.5 * torch.sum(var_ratio + t - 1.0 - torch.log(var_ratio), dim=-1)


LOG_STD_PATH = f"_AdaptActor_0/{DiagGaussianHead.PATH}/log_std"


class PPOAdaptivePolicy(MAPPOPolicy):
    """MAPPO's machinery over {"observation", "intrinsics", "observation_h"}
    with the phase's networks injected; the adaptation phase adds
    `update_adaptation`."""

    def __init__(self, cfg: PPOAdaptCfg = PPOAdaptCfg(), n_agents: int = 1, action_dim: int = 4,
                 device="cuda"):
        if cfg.phase not in PHASES:
            raise ValueError(f"phase {cfg.phase!r} is not one of {PHASES}")
        if cfg.adaptation_loss not in ADAPTATION_LOSSES:
            raise ValueError(f"unknown adaptation_loss {cfg.adaptation_loss!r}; "
                             f"have {ADAPTATION_LOSSES}")
        self.adapt_cfg = cfg
        net = functools.partial(ContextNet, condition_mode=cfg.condition_mode,
                                context_dim=cfg.context_dim)
        super().__init__(
            cfg, n_agents=n_agents, action_dim=action_dim, obs_is_dict=True, device=device,
            actor_module=functools.partial(net, out_dim=action_dim, role="actor",
                                           use_adaptation=cfg.phase != "encoder"),
            critic_module=functools.partial(net, out_dim=1, role="critic"))
        self.encoder = IntrinsicsEncoder(context_dim=cfg.context_dim)
        self.adaptation = AdaptationModule(context_dim=cfg.context_dim)
        self.actor_body = AdaptBody("actor", action_dim, cfg.condition_mode)
        self.critic_body = AdaptBody("critic", 1, cfg.condition_mode)

    @staticmethod
    def adaptation_params(ts: MAPPOState) -> torch.Tensor:
        """The adaptation module's leaves: the leading part of the actor's
        flat vector (a view; phases "adaptation" and "finetune")."""
        return ts.actor.flat[: ts.actor.n_context]

    def init_discriminator(self, generator: Optional[torch.Generator] = None):
        """(the discriminator's flat parameters, its Adam state), on the
        policy's device."""
        flat = torch.cat([init_leaf(l, generator).reshape(-1) for l in discriminator_specs(
            self.adapt_cfg.context_dim)]).to(self.device)
        return flat, AdamState.zeros_like([flat])

    def update_adaptation(
        self,
        adaptation: torch.Tensor,
        adapt_opt: AdamState,
        encoder_params: Dict[str, torch.Tensor],
        obs_history: torch.Tensor,
        intrinsics: torch.Tensor,
        obs: Optional[torch.Tensor] = None,
        actor_params: Optional[Dict[str, torch.Tensor]] = None,
        critic_params: Optional[Dict[str, torch.Tensor]] = None,
        disc: Optional[torch.Tensor] = None,
        disc_opt: Optional[AdamState] = None,
    ) -> Tuple:
        """One full-batch Adam step (`adaptation_lr`, no clip) making
        A(history) act like the frozen E(intrinsics): the MSE of the
        contexts, the KL of the actor's distributions (pred || target),
        the squared deviation of the critic's values, or both of the last
        two; or (gan / lsgan) one discriminator step (Adam 5e-4) on real z
        and fake z^, then one generator step against the updated
        discriminator.

        `adaptation` is the module's flat vector (`adaptation_params`);
        `encoder_params`, `actor_params` and `critic_params` map flax paths
        to leaves (`encoder/...`, `_AdaptActor_0/...` with its log_std at
        `LOG_STD_PATH`, `_AdaptCritic_0/...`); `disc` is the discriminator's
        flat vector.  Only the adaptation module (and the discriminator) get
        gradients.  Returns new tensors: (adaptation, adapt_opt, loss), and
        for the GAN losses also (disc, disc_opt, disc_loss)."""
        variant = self.adapt_cfg.adaptation_loss
        specs = self.adaptation.leaf_specs(obs_history.shape[-1], obs_history.shape[-2])
        with torch.no_grad():
            z = self.encoder(encoder_params, intrinsics)

        def pred_ctx(flat):
            return self.adaptation(leaf_views(specs, flat), obs_history)

        if variant in ("gan", "lsgan"):
            return self._update_gan(adaptation, adapt_opt, z, pred_ctx, disc, disc_opt,
                                    least_squares=variant == "lsgan")
        with torch.no_grad():
            if variant in ("action", "action_value"):
                log_std = actor_params[LOG_STD_PATH]
                a_target = self.actor_body(actor_params, obs, z)
            if variant in ("value", "action_value"):
                v_target = self.critic_body(critic_params, obs, z)

        def loss_fn(flat):
            if variant == "mse":
                return torch.mean(torch.square(pred_ctx(flat) - z))
            ctx = pred_ctx(flat)
            loss = 0.0
            if variant in ("action", "action_value"):
                a_pred = self.actor_body(actor_params, obs, ctx)
                loss = loss + torch.mean(gaussian_kl(a_pred, log_std, a_target, log_std))
            if variant in ("value", "action_value"):
                loss = loss + torch.mean(torch.square(self.critic_body(critic_params, obs, ctx)
                                                      - v_target))
            return loss

        new, opt, loss = _adam_step(loss_fn, adaptation, adapt_opt, self.adapt_cfg.adaptation_lr)
        return new, opt, loss

    def _update_gan(self, adaptation, adapt_opt, z, pred_ctx, disc, disc_opt,
                    least_squares: bool):
        """(reference ppo_adapt.py:481-543) The discriminator's step, real z
        -> 1 and fake z^ -> 0 (BCE, halved sum) or +1 / -1 (LSGAN); then the
        generator's, its fakes scored against the updated discriminator with
        target 1 (BCE) or +1 (LSGAN)."""
        dspecs = discriminator_specs(self.adapt_cfg.context_dim)
        with torch.no_grad():
            z_fake = pred_ctx(adaptation)

        def bce(logit, y):
            return F.binary_cross_entropy_with_logits(logit, torch.full_like(logit, y))

        def d_loss_fn(flat):
            p = leaf_views(dspecs, flat)
            real, fake = discriminate(p, z), discriminate(p, z_fake)
            if least_squares:
                return torch.mean(torch.square(real - 1.0)) + torch.mean(torch.square(fake + 1.0))
            return 0.5 * (bce(real, 1.0) + bce(fake, 0.0))

        disc, disc_opt, loss_d = _adam_step(d_loss_fn, disc, disc_opt, DISC_LR)
        dp = leaf_views(dspecs, disc)

        def g_loss_fn(flat):
            fake = discriminate(dp, pred_ctx(flat))
            if least_squares:
                return torch.mean(torch.square(fake - 1.0))
            return bce(fake, 1.0)

        new, opt, loss_g = _adam_step(g_loss_fn, adaptation, adapt_opt,
                                      self.adapt_cfg.adaptation_lr)
        return new, opt, loss_g, disc, disc_opt, loss_d


def _adam_step(loss_fn, flat: torch.Tensor, opt: AdamState, lr: float):
    """One plain Adam step of `flat` on `loss_fn(flat)`: (new flat, new
    state, loss)."""
    with torch.enable_grad():
        x = flat.detach().requires_grad_(True)
        loss = loss_fn(x)
        (grad,) = torch.autograd.grad(loss, [x])
    with torch.no_grad():
        (upd,), new_opt = adam_updates([grad], opt, lr)
        return flat.detach() + upd, new_opt, loss.detach()
