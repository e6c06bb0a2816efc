"""Convert the JAX package's parameters and env state into the port's tensors.

Inputs are nested dicts of numpy arrays: a flax parameter tree as
`jax.device_get` returns it (the entity-encoder Actor / Critic, the flat
ones, the TP net; any `LeafNet` of the port, whose leaves name their flax
paths: the relation encoders, the PPO family's networks with their `Conv`,
`GRUCell`, `MultiHeadDotProductAttention` and `LayerNorm` leaves; per-agent
actors stacked on a leading agent axis), optimizer moments unravelled into
such trees, a value
normaliser, and an env state turned into a dict (for example
`dataclasses.asdict` of a fetched `HideAndSeekState` or `HoverState`).  The port
itself never imports JAX; the caller does the fetch.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .controllers import PIDRateState
from .dynamics import DroneState, QuadrotorParams
from .envs.genbuffer import GenBufferState
from .envs.hideandseek import HideAndSeekState
from .envs.hover import HoverState
from .learning.mappo import AgentStack, MAPPOPolicy, MAPPOState
from .learning.modules.networks import entity_group_order
from .learning.optim import AdamState
from .learning.valuenorm import ValueNorm1, ValueNorm2

_GATES = ("i", "f", "g", "o")


def _t(a, device) -> torch.Tensor:
    arr = np.array(a)  # a writable, contiguous copy
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float32, copy=False)
    return torch.from_numpy(arr).to(device)


def group_names(params: Mapping) -> list:
    """Entity groups of a flax actor/critic tree, in canonical order."""
    enc = _encoder(params)
    se = enc["SplitEmbedding_0"]
    return entity_group_order(k[len("embed_"):] for k in se if k.startswith("embed_"))


def _encoder(params: Mapping) -> Mapping:
    p = params["params"]
    return p[next(k for k in p if k.startswith("PartialAttentionEncoder"))]


def encoder_leaves(params: Mapping, device="cpu") -> Tuple[torch.Tensor, ...]:
    """Flax Actor/Critic tree → canonical leaves (the order of
    mupe_tpu/ops/fused_encoder.py `extract_leaves`), with the attention
    kernels reshaped from flax's [in, heads, head] / [heads, head, out]."""
    p = params["params"]
    enc = _encoder(params)
    se = enc["SplitEmbedding_0"]
    attn = enc["attn"]
    e = np.asarray(se["LayerNorm_0"]["scale"]).shape[0]
    leaves = []
    for name in group_names(params):
        leaves += [se[f"embed_{name}"]["kernel"], se[f"embed_{name}"]["bias"]]
    leaves += [se["LayerNorm_0"]["scale"], se["LayerNorm_0"]["bias"]]
    for proj in ("query", "key", "value", "out"):
        kernel = np.asarray(attn[proj]["kernel"]).reshape(e, e)
        bias = np.asarray(attn[proj]["bias"]).reshape(e)
        leaves += [kernel, bias]
    leaves += [enc["LayerNorm_0"]["scale"], enc["LayerNorm_0"]["bias"]]
    leaves += [enc["Dense_0"]["kernel"], enc["Dense_0"]["bias"]]
    leaves += [enc["Dense_1"]["kernel"], enc["Dense_1"]["bias"]]
    leaves += [enc["LayerNorm_1"]["scale"], enc["LayerNorm_1"]["bias"]]
    head = p["DiagGaussianHead_0"]["Dense_0"] if "DiagGaussianHead_0" in p else p["Dense_0"]
    leaves += [head["kernel"], head["bias"]]
    return tuple(_t(l, device) for l in leaves)


def flat_leaves(params: Mapping, device="cpu") -> Tuple[torch.Tensor, ...]:
    """Flax flat Actor / Critic tree (`FlatEncoder` + head) → the leaves of
    `FlatHeadNet`: the input LayerNorm's scale and bias, (kernel, bias, ln
    scale, ln bias) per MLP layer, the head's kernel and bias."""
    p = params["params"]
    enc = p["FlatEncoder_0"]
    mlp = enc["MLP_0"]
    leaves = [enc["LayerNorm_0"]["scale"], enc["LayerNorm_0"]["bias"]]
    for i in range(sum(k.startswith("Dense_") for k in mlp)):
        leaves += [mlp[f"Dense_{i}"]["kernel"], mlp[f"Dense_{i}"]["bias"],
                   mlp[f"LayerNorm_{i}"]["scale"], mlp[f"LayerNorm_{i}"]["bias"]]
    head = p["DiagGaussianHead_0"]["Dense_0"] if "DiagGaussianHead_0" in p else p["Dense_0"]
    leaves += [head["kernel"], head["bias"]]
    return tuple(_t(l, device) for l in leaves)


def _network_leaves(params: Mapping, device="cpu") -> Tuple[torch.Tensor, ...]:
    """Either network kind's leaves, by the tree's encoder."""
    if "FlatEncoder_0" in params["params"]:
        return flat_leaves(params, device)
    return encoder_leaves(params, device)


def actor_log_std(params: Mapping, device="cpu") -> torch.Tensor:
    """The `DiagGaussianHead`'s log_std, at the tree's root or inside
    ppo_adapt's actor body (`_AdaptActor_0`)."""
    p = params["params"]
    p = p.get("_AdaptActor_0", p)
    return _t(p["DiagGaussianHead_0"]["log_std"], device)


def tp_leaves(params: Mapping, device="cpu") -> Tuple[torch.Tensor, ...]:
    """TPNet tree → (wi [F, 4H], wh [H, 4H], b [4H], wfc [H, O], bfc [O]),
    gates concatenated in (i, f, g, o) order (`extract_tp_leaves`)."""
    p = params["params"]
    cell = p.get("OptimizedLSTMCell_0")
    if cell is None:
        cell = p["lstm"]
        while "ii" not in cell:  # nn.RNN nests the cell one level down
            cell = cell[next(iter(cell))]
    wi = np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]) for g in _GATES], axis=1)
    wh = np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]) for g in _GATES], axis=1)
    b = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in _GATES], axis=0)
    return tuple(_t(a, device) for a in (wi, wh, b, p["fc"]["kernel"], p["fc"]["bias"]))


def _path(tree: Mapping, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def named_leaves(params: Mapping, net, agent=None, device="cpu") -> Tuple[torch.Tensor, ...]:
    """A flax tree → the leaves of the port's `LeafNet` `net`, each found
    by its flax path and reshaped to the port's layout (flax's attention
    kernels [in, heads, head] and [heads, head, out] row-major, which keeps
    the heads' split as column blocks; a 1-d Conv's [k, in, out] unchanged;
    a 2-d Conv's [kh, kw, in, out], depthwise [kh, kw, 1, C], transposed
    to torch's [out, in, kh, kw] by the leaf's `perm`).
    `agent` picks one agent's parameters from a stacked tree."""
    p = params["params"]
    out = []
    for leaf in net.leaf_specs():
        a = np.asarray(_path(p, leaf.path))
        a = a if agent is None else a[agent]
        if leaf.perm is not None:
            a = np.transpose(a, leaf.perm)
        out.append(_t(np.reshape(a, leaf.shape), device))
    return tuple(out)


def _stacked(tree, agent: int):
    if isinstance(tree, Mapping):
        return {k: _stacked(v, agent) for k, v in tree.items()}
    return np.asarray(tree)[agent]


def leaves_of(net, params: Mapping, agent=None) -> Tuple[torch.Tensor, ...]:
    """`net`'s leaves from a flax tree: by path for a `LeafNet`, by the
    tree's encoder for an `EncoderHead` / `FlatHeadNet`."""
    if hasattr(net, "leaf_specs"):
        return named_leaves(params, net, agent)
    return _network_leaves(params if agent is None else _stacked(params, agent))


def policy_state(
    policy: MAPPOPolicy,
    obs_example: Mapping[str, torch.Tensor],
    actor_params: Mapping,
    critic_params: Mapping,
    tp_params: Mapping | None = None,
    state_example=None,
) -> MAPPOState:
    """A `MAPPOState` holding the converted JAX parameters; `obs_example`
    (a port observation) gives the token groups, or the flat width, and
    `state_example` the centralized critic's.  Per-agent actors
    (`share_actor=False`) take the JAX package's stacked tree."""
    shapes = policy.init(obs_example, state_example=state_example,
                         generator=torch.Generator().manual_seed(0))
    if isinstance(shapes.actor, AgentStack):
        actor = [leaves_of(net, actor_params, i) for i, net in enumerate(shapes.actor.nets)]
    else:
        actor = leaves_of(shapes.actor, actor_params)
    return policy.init(
        obs_example,
        actor_leaves=actor,
        log_std=actor_log_std(actor_params),
        critic_leaves=leaves_of(shapes.critic, critic_params),
        tp_leaves=tp_leaves(tp_params) if tp_params is not None else None,
        state_example=state_example,
    )


def rnn_policy_state(policy, obs_example, actor_params: Mapping, critic_params: Mapping):
    """A `PPORNNState` holding the converted JAX parameters."""
    shapes = policy.init(obs_example, generator=torch.Generator().manual_seed(0))
    return policy.init(obs_example, actor_leaves=named_leaves(actor_params, shapes.actor),
                       log_std=actor_log_std(actor_params),
                       critic_leaves=named_leaves(critic_params, shapes.critic))


def value_norm(d: Mapping[str, Any], device="cpu") -> ValueNorm1:
    """JAX `ValueNorm1` (as a dict of numpy arrays) → the port's."""
    return ValueNorm1(
        running_mean=_t(d["running_mean"], device),
        running_mean_sq=_t(d["running_mean_sq"], device),
        debiasing_term=_t(d["debiasing_term"], device),
        beta=float(d.get("beta", 0.995)),
        epsilon=float(d.get("epsilon", 1e-5)),
    )


def value_norm2(d: Mapping[str, Any], device="cpu") -> ValueNorm2:
    """JAX `ValueNorm2` (as a dict of numpy arrays) → the port's."""
    return ValueNorm2(
        running_mean=_t(d["running_mean"], device),
        running_var=_t(d["running_var"], device),
        count=_t(d["count"], device),
        subtract_mean=bool(d.get("subtract_mean", True)),
    )


def _group_tensors(tree: Mapping, device) -> list:
    """A parameter-shaped tree → the port's parameter group: [flat network
    leaves, log_std] (actor), [flat network leaves] (critic) or the TP net's
    five leaves."""
    p = tree["params"]
    if "FlatEncoder_0" in p or any(k.startswith("PartialAttentionEncoder") for k in p):
        group = [torch.cat([l.reshape(-1) for l in _network_leaves(tree, device)])]
        if "DiagGaussianHead_0" in p:
            group.append(actor_log_std(tree, device))
        return group
    return list(tp_leaves(tree, device))


def adam_state(mu_tree: Mapping, nu_tree: Mapping, count, device="cpu") -> AdamState:
    """optax Adam moments → the port's `AdamState`.  The JAX optimizers run
    on flattened vectors (`optax.flatten`); unravel each moment into the
    parameter tree first (`jax.flatten_util.ravel_pytree`'s unravel) and
    pass the trees, as numpy arrays."""
    return AdamState(
        mu=_group_tensors(mu_tree, device),
        nu=_group_tensors(nu_tree, device),
        count=torch.as_tensor(np.array(count), dtype=torch.int32).to(device),
    )


def env_state(d: Mapping[str, Any], device="cpu") -> HideAndSeekState:
    """JAX `HideAndSeekState` (as a dict of numpy arrays) → the port's state,
    the AEG buffer (`gen`, a `GenBufferState` as a dict) included.  The JAX
    state's PRNG key has no counterpart here."""
    dr, pid = d["drone"], d["pid"]
    return HideAndSeekState(
        drone=DroneState(**{k: _t(dr[k], device)
                            for k in ("pos", "quat", "vel", "angvel", "throttle")}),
        pid=PIDRateState(integ=_t(pid["integ"], device),
                         last_body_rate=_t(pid["last_body_rate"], device)),
        prev_action=_t(d["prev_action"], device),
        target_pos=_t(d["target_pos"], device),
        target_vel=_t(d["target_vel"], device),
        cylinders=_t(d["cylinders"], device),
        progress=_t(np.asarray(d["progress"]).astype(np.int32), device),
        v_prey=_t(d["v_prey"], device),
        history=_t(d["history"], device),
        stats={k: _t(v, device) for k, v in d["stats"].items()},
        update_epoch=_t(d["update_epoch"], device),
        tp_pred=_t(d["tp_pred"], device),
        gen=None if d.get("gen") is None else GenBufferState(
            **{k: _t(v, device) for k, v in d["gen"].items()}),
    )


def _quadrotor_params(d: Mapping[str, Any], device) -> QuadrotorParams:
    arrays = ("mass", "inertia", "kf", "km", "directions", "tau_up", "tau_down", "rotor_pos",
              "drag_coef")
    return QuadrotorParams(
        **{k: _t(d[k], device) for k in arrays},
        target_clip=float(d["target_clip"]), max_thrust_ratio=float(d["max_thrust_ratio"]),
        fixed_yaw=bool(d["fixed_yaw"]), num_rotors=int(d["num_rotors"]),
    )


def hover_state(d: Mapping[str, Any], device="cpu") -> HoverState:
    """JAX `HoverState` (as a dict of numpy arrays) → the port's state, the
    per-env randomized parameters included.  The PRNG key has no
    counterpart here."""
    dr, pid = d["drone"], d["pid"]
    dyn, intr, obs_h = (d.get(k) for k in ("dyn_params", "intrinsics", "obs_h"))
    return HoverState(
        drone=DroneState(**{k: _t(dr[k], device)
                            for k in ("pos", "quat", "vel", "angvel", "throttle")}),
        pid=PIDRateState(integ=_t(pid["integ"], device),
                         last_body_rate=_t(pid["last_body_rate"], device)),
        progress=_t(np.asarray(d["progress"]).astype(np.int32), device),
        stats={k: _t(v, device) for k, v in d["stats"].items()},
        **{k: _t(d[k], device) for k in (
            "prev_action", "target_pos", "target_heading", "last_linear_v", "last_angular_v",
            "last_linear_a", "last_angular_a", "payload_mass", "payload_z", "obs_buf")},
        dyn_params=None if dyn is None else _quadrotor_params(dyn, device),
        intrinsics=None if intr is None else _t(intr, device),
        obs_h=None if obs_h is None else _t(obs_h, device),
    )


def tensors(d: Mapping[str, Any], device="cpu") -> Dict[str, torch.Tensor]:
    """A flat dict of numpy arrays (an observation, stats) → tensors."""
    return {k: _t(v, device) for k, v in d.items()}
