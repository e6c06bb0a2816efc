"""MAPPO's update in plain PyTorch: GAE, the value normaliser, the TP net's
supervised step, the PPO minibatches (actor and critic in one loss over
entity groups; an actor step, then a critic step, over flat observations),
clip by global norm and Adam, as the configuration states them (reference
cfg/algo/mappo.yaml, as mupe_tpu_torch/learning/mappo.py computes them at
the benchmark's first version).  Gradients come from autograd through
`nets`; the reference works on one process's arenas.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

import torch

from . import nets


@dataclasses.dataclass
class Adam:
    """One parameter group's Adam moments and step count."""

    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int = 0

    @classmethod
    def zeros(cls, params):
        return cls([torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])

    def step(self, params, grads, lr, b1=0.9, b2=0.999, eps=1e-8) -> List[torch.Tensor]:
        self.count += 1
        self.mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, self.mu)]
        self.nu = [(1 - b2) * g * g + b2 * v for g, v in zip(grads, self.nu)]
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        return [p - lr * (m / c1) / (torch.sqrt(v / c2) + eps)
                for p, m, v in zip(params, self.mu, self.nu)]


def clip_global(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    return [g if norm < max_norm else g / norm * max_norm for g in grads]


def huber_sum(pred, target, delta):
    err = torch.abs(pred - target)
    quad = torch.clamp(err, max=delta)
    return torch.sum(0.5 * quad * quad + delta * (err - quad))


@dataclasses.dataclass
class Learner:
    """Parameters, optimizer states and the value normaliser."""

    actor: List[torch.Tensor]
    log_std: torch.Tensor
    critic: List[torch.Tensor]
    tp: Optional[List[torch.Tensor]]
    cfg: Dict[str, Any]
    groups: Any = None        # entity groups (tokens, features) in order, or None
    names: Any = None         # their observation keys
    hidden: Any = None        # the flat networks' widths
    rnd: Callable = nets.bf16
    vn: Any = None

    def __post_init__(self):
        self.actor_opt = Adam.zeros(self.actor + [self.log_std])
        self.critic_opt = Adam.zeros(self.critic)
        self.tp_opt = Adam.zeros(self.tp) if self.tp is not None else None
        dev = self.log_std.device
        self.vn = [torch.zeros(1, device=dev), torch.zeros(1, device=dev),
                   torch.zeros((), device=dev)]

    # ---------------------------------------------------------- networks
    def rows(self, obs) -> torch.Tensor:
        """Entity-group observations [..., n, k, d] → rows [..., n, obs_dim]."""
        lead = obs[self.names[0]].shape[:-2]
        return torch.cat([obs[k].reshape(lead + (-1,)) for k in self.names], dim=-1)

    def mean(self, x, actor=None):
        leaves = self.actor if actor is None else actor
        if self.groups is not None:
            return nets.encoder(self.groups, leaves, x.reshape(-1, x.shape[-1]),
                                self.rnd).reshape(x.shape[:-1] + (-1,))
        return nets.flat(self.hidden, leaves, x, self.rnd)

    def value(self, x, critic=None):
        leaves = self.critic if critic is None else critic
        if self.groups is not None:
            return nets.encoder(self.groups, leaves, x.reshape(-1, x.shape[-1]),
                                self.rnd).reshape(x.shape[:-1] + (1,))
        return nets.flat(self.hidden, leaves, x, self.rnd)

    def tp_predict(self, x, leaves=None):
        return nets.tp(self.tp if leaves is None else leaves, x, self.rnd)

    def obs_rows(self, obs):
        return self.rows(obs) if self.groups is not None else obs

    # ---------------------------------------------------------- value norm
    def _mean_var(self):
        d = torch.clamp(self.vn[2], min=1e-5)
        mean, sq = self.vn[0] / d, self.vn[1] / d
        return mean, torch.clamp(sq - mean * mean, min=1e-2)

    def _vn_update(self, batch):
        w = self.cfg["value_norm_beta"]
        self.vn = [self.vn[0] * w + batch.mean() * (1 - w),
                   self.vn[1] * w + (batch * batch).mean() * (1 - w),
                   self.vn[2] * w + (1 - w)]

    # ---------------------------------------------------------- update
    def train_op(self, traj, last_obs, perms, half: bool = False,
                 first: Optional[Dict[str, Any]] = None,
                 max_steps: Optional[int] = None) -> Dict[str, Any]:
        """One update on a rollout `traj` ([T, E, ...] fields) with the
        minibatch permutations `perms` [epochs, T*E], stopped after
        `max_steps` minibatches if given.  `half` leaves out the second
        half of each minibatch's rows (a fault).  `first`, if given,
        receives the first minibatch's clipped gradients.  Returns the TP
        loss and each minibatch's (policy loss, value loss)."""
        cfg = self.cfg
        reward = traj["reward"]
        t_len, e, n = reward.shape[:3]
        with torch.no_grad():
            mean, var = self._mean_var()
            std = torch.sqrt(var)
            nv = self.value(self.obs_rows(last_obs)).reshape(e * n) * std + mean
            values = traj["value"].reshape(t_len, e * n) * std + mean
            r = reward.reshape(t_len, e * n)
            nd = 1.0 - traj["done"][:, :, None, 0].expand(t_len, e, n).reshape(t_len, e * n).float()
            v_next = torch.cat([values[1:], nv[None]], 0)
            delta = r + cfg["gamma"] * v_next * nd - values
            adv = torch.empty_like(r)
            g = torch.zeros_like(r[0])
            for t in reversed(range(t_len)):
                g = delta[t] + cfg["gamma"] * cfg["gae_lambda"] * nd[t] * g
                adv[t] = g
            ret = adv + values
            adv = (adv - adv.mean()) / (torch.sqrt(((adv - adv.mean()) ** 2).mean()) + 1e-8)
            self._vn_update(ret)
            mean, var = self._mean_var()
            ret = (ret - mean) / torch.sqrt(var)
        out: Dict[str, Any] = {}
        if self.tp is not None:
            out["TP_loss"] = self.tp_step(traj)
        x = self.obs_rows(traj["obs"]).reshape((t_len * e, n, -1))
        fields = {"x": x, "action": traj["action"].reshape(t_len * e, n, -1),
                  "logp": traj["logp"].reshape(t_len * e, n),
                  "value": traj["value"].reshape(t_len * e, n),
                  "adv": adv.reshape(t_len * e, n), "ret": ret.reshape(t_len * e, n)}
        m = cfg["num_minibatches"]
        size = t_len * e // m
        steps = []
        for epoch in range(cfg["ppo_epochs"]):
            for idx in perms[epoch][: size * m].reshape(m, size):
                if max_steps is not None and len(steps) == max_steps:
                    break
                if half:
                    idx = idx[: size // 2]
                mb = {k: v[idx] for k, v in fields.items()}
                steps.append(tuple(float(v) for v in self._minibatch(mb, first)))
                first = None
        out["steps"] = steps
        return out

    def _minibatch(self, mb, first):
        cfg = self.cfg
        a_dim = mb["action"].shape[-1]
        count = mb["logp"].numel()
        clip = cfg["clip_param"]
        actor = [p.detach().requires_grad_(True) for p in self.actor]
        log_std = self.log_std.detach().requires_grad_(True)
        critic = [p.detach().requires_grad_(True) for p in self.critic]
        mean = self.mean(mb["x"], actor)
        logp = nets.log_prob(mb["action"], mean, log_std)
        ratio = torch.exp(torch.clamp(logp - mb["logp"], -20.0, 20.0))
        adv = mb["adv"]
        surr = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        policy_loss = -torch.sum(surr * a_dim) / count
        values = self.value(mb["x"], critic)[..., 0]
        clipped = mb["value"] + torch.clamp(values - mb["value"], -clip, clip)
        h1 = huber_sum(values, mb["ret"], cfg["huber_delta"]) / count
        h2 = huber_sum(clipped, mb["ret"], cfg["huber_delta"]) / count
        value_loss = h1 if h1 > h2 else (h2 if h2 > h1 else 0.5 * (h1 + h2))
        if self.groups is not None:
            # one loss, one backward: the joint update
            ga_c = torch.autograd.grad(policy_loss + value_loss, actor + [log_std] + critic)
            ga, gc = list(ga_c[:len(actor) + 1]), list(ga_c[len(actor) + 1:])
            ga[-1] = ga[-1] - cfg["entropy_coef"]
        else:
            ent = -torch.sum(nets.entropy(log_std, mean.shape)) / count
            ga = list(torch.autograd.grad(policy_loss + cfg["entropy_coef"] * ent,
                                          actor + [log_std]))
            gc = list(torch.autograd.grad(value_loss, critic))
        ga, gc = clip_global(ga, cfg["max_grad_norm"]), clip_global(gc, cfg["max_grad_norm"])
        if first is not None:
            first["actor"] = [g.detach().clone() for g in ga[:-1]]
            first["log_std"] = ga[-1].detach().clone()
            first["critic"] = [g.detach().clone() for g in gc]
        with torch.no_grad():
            new = self.actor_opt.step(self.actor + [self.log_std], ga, cfg["actor_lr"])
            self.actor, self.log_std = new[:-1], new[-1]
            self.critic = self.critic_opt.step(self.critic, gc, cfg["critic_lr"])
        return policy_loss.detach(), torch.maximum(h1, h2).detach()

    def tp_step(self, traj) -> float:
        """The TP net's supervised step on a rollout; returns its loss."""
        cfg = self.cfg
        w = cfg["future_prediction_step"]
        gt, inp = traj["tp_gt"], traj["tp_input"]
        n_win = gt.shape[0] - w
        dev = gt.device
        idx = torch.arange(n_win, device=dev)[:, None] + torch.arange(1, w + 1, device=dev)[None]
        targets = gt[idx].transpose(1, 2)
        targets = targets.reshape(targets.shape[:2] + (w * 3,))
        done = traj["done"][..., 0].bool()[idx]
        valid = ((~torch.any(done, dim=1)) & traj["tp_done"][:n_win, :, 0].bool()).float()[..., None]
        x = inp[:n_win].reshape((-1,) + tuple(inp.shape[2:]))
        leaves = [p.detach().requires_grad_(True) for p in self.tp]
        pred = self.tp_predict(x, leaves).reshape(targets.shape)
        loss = torch.sum((pred - targets) ** 2 * valid) / (torch.sum(valid) * targets.shape[-1]
                                                           + 1e-8)
        grads = torch.autograd.grad(loss, leaves)
        if self.tp_opt.count == 0:
            self.first_tp = [g.detach().clone() for g in grads]
        with torch.no_grad():
            self.tp = self.tp_opt.step(self.tp, list(grads), cfg["tp_lr"])
        return float(loss.detach())


def leaf_norms(leaves: List[torch.Tensor]) -> List[float]:
    return [float(torch.linalg.vector_norm(l.double())) for l in leaves]


def leaf_gaps(prog: List[float], ref: List[float],
              keep: Optional[List[bool]] = None) -> List[float]:
    """Each kept leaf's gap between two norms, against the reference's norm
    of that leaf or of the median kept leaf, whichever is larger."""
    if keep is None:
        keep = [True] * len(ref)
    kept = [r for r, k in zip(ref, keep) if k]
    med = sorted(kept)[len(kept) // 2] if kept else 0.0
    return [abs(p - r) / max(r, med, 1e-30) for p, r, k in zip(prog, ref, keep) if k]


def gap_by_leaf(prog: List[float], ref: List[float], keep: Optional[List[bool]] = None) -> float:
    """The worst leaf's gap (`leaf_gaps`)."""
    return max(leaf_gaps(prog, ref, keep), default=0.0)


def median_gap(prog: List[float], ref: List[float], keep: Optional[List[bool]] = None) -> float:
    """The median leaf's gap (`leaf_gaps`; of an even count, the upper
    one): a number that one leaf cannot swing, where Adam's first step
    moves a leaf by about its learning rate on every element whatever
    the size of the gradient, so that signs which rounding flips in a
    near-zero gradient move a small leaf's change by its own size."""
    gaps = sorted(leaf_gaps(prog, ref, keep))
    return gaps[len(gaps) // 2] if gaps else 0.0


def group_median_gap(prog: List[float], ref: List[float], groups: List[str],
                     keep: Optional[List[bool]] = None) -> float:
    """The largest, over parameter groups, of the group's median leaf's gap
    (`median_gap` within the group): a fault confined to one group (the
    critic's step, the TP net's gradient) moves that group's median where
    the other groups' leaves hold the median of them all."""
    if keep is None:
        keep = [True] * len(ref)
    out = 0.0
    for g in dict.fromkeys(groups):
        idx = [i for i, x in enumerate(groups) if x == g]
        out = max(out, median_gap([prog[i] for i in idx], [ref[i] for i in idx],
                                  [keep[i] for i in idx]))
    return out


def widest_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest elementwise gap against the reference's largest value."""
    prog, ref = prog.double(), ref.double()
    scale = float(torch.amax(torch.abs(ref))) if ref.numel() else 0.0
    if prog.shape != ref.shape:
        return math.inf
    return float(torch.amax(torch.abs(prog - ref))) / max(scale, 1e-12) if ref.numel() else 0.0

