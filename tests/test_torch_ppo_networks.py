"""The networks of MAPPO's options and of the PPO family in the PyTorch port
against the JAX package's flax modules on the CPU: the relation encoders
(float32 and bfloat16), `DiagGaussianHead`, the privileged branch,
`TConvEncoder`, the transformer (a global token set and per-agent
observations), `PointNetEncoder` and `MaskedGRU` (with `is_init` set on
some rows).  The flax parameters are converted by `bridge.named_leaves`,
perturbed first (LayerNorm scales and biases off their defaults, heads at
unit gain) so that every leaf moves the output.

Tolerances.  float32: the forward and the gradients of a random cotangent
within 1e-5 of each tensor's scale (its largest magnitude; the two sides
sum the same products in other orders); an attention key bias, whose
gradient is analytically zero (the softmax ignores a shift of a query's
logits) and rounding noise on both sides, within 1e-5 of the network's
largest gradient.  bfloat16 (the relation
encoders, whose `compute_dtype` the JAX modules take): the floor is the
JAX module's own bf16-vs-f32 difference on the same inputs; the port's
bf16 output and gradients are within 2x the floor of JAX's bf16 (max and
mean, per leaf, + 1e-6 of the scale where a leaf's floor is ~0), and, as a
control, differ from the port's own f32 by at least half the floor's mean
(a port that ignored `compute_dtype` would differ by nothing).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.learning.mappo import Actor as JActor
from mupe_tpu.learning.modules.distributions import DiagGaussianHead as JHead
from mupe_tpu.learning.modules.rnn import MaskedGRU as JGRU
from mupe_tpu.learning.ppo.ppo import _FlatActor, _PrivActor, _PrivCritic
from mupe_tpu.learning.ppo.ppo_sdf_nav import _SDFNavActor
from mupe_tpu.learning.ppo.ppo_tconv import _TConvActor, _TConvCritic
from mupe_tpu.learning.ppo.transformer import _TransformerActor, _TransformerCritic
from mupe_tpu_torch import bridge
from mupe_tpu_torch.learning.modules.distributions import DiagGaussianHead
from mupe_tpu_torch.learning.modules.networks import LeafNet, RelationHeadNet, init_leaf
from mupe_tpu_torch.learning.modules.rnn import masked_gru, masked_gru_leaves
from mupe_tpu_torch.learning.ppo.ppo import FlatNet, PPOCfg, PPOPolicy, PrivNet
from mupe_tpu_torch.learning.ppo.ppo_sdf_nav import SDFNavNet
from mupe_tpu_torch.learning.ppo.ppo_tconv import TConvNet, tconv_steps
from mupe_tpu_torch.learning.ppo.transformer import TransformerNet

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
F32_REL = 1e-5
FLOOR_MULT, CONTROL_FRAC = 2.0, 0.5


def _perturb(tree, rng, path=""):
    """Random leaves of unit scale in place of flax's initial values."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, f"{path}/{k}") for k, v in tree.items()}
    shape = np.shape(tree)
    name = path.rsplit("/", 1)[-1]
    if name == "scale":
        v = rng.uniform(0.5, 1.5, shape)
    elif name in ("bias", "log_std"):
        v = rng.normal(0.0, 0.1, shape)
    else:
        fan = np.prod(shape[:-1]) if ("Conv" in path or "/out/" in path or len(shape) == 2) \
            else shape[0]
        v = rng.normal(size=shape) / np.sqrt(fan)
    return jnp.asarray(v.astype(np.float32))


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree))


def _run(jmodule, params, jargs, net, targs, cot, out=lambda o: o):
    """(JAX output, JAX gradient leaves in the port's order, port output,
    port gradient leaves) for the cotangent `cot`."""
    jf = lambda p: out(jmodule.apply(p, *jargs))
    jout = jax.jit(jf)(params)
    jgrad = jax.jit(jax.grad(lambda p: jnp.sum(jf(p).astype(jnp.float32) * cot)))(params)
    tout = net(*targs)
    tout = tout[0] if isinstance(tout, tuple) else tout
    (tg,) = torch.autograd.grad(torch.sum(tout.float() * torch.as_tensor(cot)), [net.flat])
    shapes = net.leaf_shapes()
    tgrads = torch.split(tg, [int(np.prod(s)) for s in shapes])
    return (np.asarray(jout, np.float32), [_np(g) for g in bridge.named_leaves(jgrad, net)],
            _np(tout), [_np(g) for g in tgrads], [l.path for l in net.leaf_specs()])


def _hold_f32(jout, jgrads, tout, tgrads, paths):
    np.testing.assert_allclose(tout, jout, rtol=0, atol=F32_REL * np.abs(jout).max())
    net_scale = max(np.abs(j).max() for j in jgrads)
    for t, j, path in zip(tgrads, jgrads, paths):
        scale = net_scale if path.endswith("/key/bias") else np.abs(j).max()
        np.testing.assert_allclose(t.reshape(j.shape), j, rtol=0, atol=F32_REL * max(scale, 1e-30),
                                   err_msg=path)


def _check(jmodule, jargs, make_net, targs, out=lambda o: o, seed=0):
    init = jax.jit(jmodule.init)(KEY, *jargs)["params"]
    params = {"params": _perturb(init, np.random.default_rng(seed))}
    net = make_net(leaves=None)
    net = make_net(leaves=bridge.named_leaves(params, net))
    shape = jax.eval_shape(lambda p: out(jmodule.apply(p, *jargs)), params).shape
    cot = np.random.default_rng(seed + 1).normal(size=shape).astype(np.float32)
    _hold_f32(*_run(jmodule, params, jargs, net, targs, cot, out))
    return net


# ------------------------------------------------------------------ relation encoders
def _entity_obs(rng, lead=(6, 3)):
    return {"state_self": rng.normal(size=lead + (1, 11)).astype(np.float32),
            "cylinders": rng.normal(size=lead + (3, 5)).astype(np.float32),
            "state_others": rng.normal(size=lead + (2, 3)).astype(np.float32)}


def _relation(encoder, dtype, obs, params, cot):
    jm = JActor(action_dim=4, hidden_units=(), attn_encoder=encoder, obs_is_dict=True,
                dtype=jnp.dtype(dtype))
    groups = {k: v.shape[-2:] for k, v in obs.items()}
    make = functools.partial(RelationHeadNet, encoder, groups, 4, "actor", getattr(torch, dtype))
    net = make(leaves=bridge.named_leaves(params, make(leaves=None)))
    return _run(jm, params, (jax.tree_util.tree_map(jnp.asarray, obs),), net, (_t(obs),), cot,
                out=lambda d: d.mean)


@pytest.mark.parametrize("encoder", ["RelationEncoder", "PartialRelationEncoder"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relation_encoders_match_flax(encoder, dtype):
    rng = np.random.default_rng(3)
    obs = _entity_obs(rng)
    jm = JActor(action_dim=4, hidden_units=(), attn_encoder=encoder, obs_is_dict=True)
    params = {"params": _perturb(jax.jit(jm.init)(KEY, obs)["params"], rng)}
    cot = rng.normal(size=(6, 3, 4)).astype(np.float32)
    got = _relation(encoder, dtype, obs, params, cot)
    if dtype == "float32":
        _hold_f32(*got)
        return
    j32, jg32, t32, tg32, _ = _relation(encoder, "float32", obs, params, cot)
    jout, jg, tout, tg, _ = got
    pairs = [(tout, jout, j32, t32)] + list(zip(tg, jg, jg32, tg32))
    ctrl = base = 0.0
    for i, (t, j, f, c) in enumerate(pairs):
        t = t.reshape(j.shape)
        err, floor = np.abs(t - j), np.abs(f - j)
        slack = 1e-6 * np.abs(j).max()
        assert err.max() <= FLOOR_MULT * floor.max() + slack, (i, err.max(), floor.max())
        assert err.mean() <= FLOOR_MULT * floor.mean() + slack, (i, err.mean(), floor.mean())
        ctrl += np.abs(t - c.reshape(j.shape)).sum()
        base += floor.sum()
    assert ctrl >= CONTROL_FRAC * base, (ctrl, base)


# ------------------------------------------------------------------ DiagGaussianHead
class _HeadOnly(LeafNet):
    def __init__(self, d, a, leaves=None, generator=None):
        super().__init__()
        self.d, self.a = d, a
        self._make_flat(leaves, generator)

    def leaf_specs(self):
        return DiagGaussianHead.leaf_specs(self.d, self.a)

    def forward(self, x):
        return DiagGaussianHead.mean(self.params(), x)


def test_diag_gaussian_head_matches_flax():
    """The mean and its gradients; the initial kernel's xavier bound (gain
    0.01), zero bias and zero log_std; log-prob and entropy."""
    import flax.linen as nn

    class Wrap(nn.Module):
        @nn.compact
        def __call__(self, x):
            return JHead(4, name="DiagGaussianHead_0")(x)

    rng = np.random.default_rng(4)
    x = rng.normal(size=(32, 2, 64)).astype(np.float32)
    _check(Wrap(), (jnp.asarray(x),), functools.partial(_HeadOnly, 64, 4), (torch.as_tensor(x),),
           out=lambda d: d.mean)
    init = JHead(4).init(KEY, jnp.asarray(x))["params"]
    assert float(np.abs(np.asarray(init["log_std"])).max()) == 0.0
    bound = 0.01 * np.sqrt(6.0 / (64 + 4))
    w = init_leaf(DiagGaussianHead.leaf_specs(64, 4)[0], torch.Generator().manual_seed(0))
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert float(np.abs(np.asarray(init["Dense_0"]["kernel"])).max()) <= bound
    ts = PPOPolicy(PPOCfg(), device="cpu").init(torch.zeros((2, 1, 64)))
    assert float(ts.log_std.abs().max()) == 0.0 and tuple(ts.log_std.shape) == (4,)


# ------------------------------------------------------------------ the PPO family's bodies
def test_flat_actor_matches_flax_and_has_no_input_layernorm():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(16, 1, 20)).astype(np.float32)
    net = _check(_FlatActor(4), (jnp.asarray(x),),
                 functools.partial(FlatNet, x, out_dim=4, role="actor"), (torch.as_tensor(x),),
                 out=lambda d: d.mean)
    assert net.leaf_specs()[0].path == "MLP_0/Dense_0/kernel"


@pytest.mark.parametrize("role", ["actor", "critic"])
def test_privileged_branch_matches_flax(role):
    rng = np.random.default_rng(6)
    obs = {"observation": rng.normal(size=(16, 1, 20)).astype(np.float32),
           "intrinsics": rng.normal(size=(16, 1, 22)).astype(np.float32)}
    jm = _PrivActor(4) if role == "actor" else _PrivCritic()
    _check(jm, (jax.tree_util.tree_map(jnp.asarray, obs),),
           functools.partial(PrivNet, obs, out_dim=4 if role == "actor" else 1, role=role),
           (_t(obs),), out=(lambda d: d.mean) if role == "actor" else (lambda o: o))


@pytest.mark.parametrize("role", ["actor", "critic"])
def test_tconv_encoder_matches_flax(role):
    """Channels-last convolutions, flattened time-major: at 32 frames 5 steps
    x 64 channels = 320 features into MLP((256,))."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(8, 1, 32, 20)).astype(np.float32)
    jm = _TConvActor(4) if role == "actor" else _TConvCritic()
    obs = {"observation": x[..., 0, :], "observation_h": x}
    net = _check(jm, (jax.tree_util.tree_map(jnp.asarray, obs),),
                 functools.partial(TConvNet, obs, out_dim=4 if role == "actor" else 1, role=role),
                 (_t(obs),), out=(lambda d: d.mean) if role == "actor" else (lambda o: o))
    assert tconv_steps(32) == 5
    assert dict((l.path, l.shape) for l in net.leaf_specs())[
        "TConvEncoder_0/MLP_0/Dense_0/kernel"] == (320, 256)


@pytest.mark.parametrize("per_agent", [False, True])
@pytest.mark.parametrize("role", ["actor", "critic"])
def test_transformer_matches_flax(per_agent, role):
    """Global token sets ([E, k, d], agents first) and per-agent ones
    ([E, n, k, d], HideAndSeek's); 4 heads of 32, tanh GELU, LayerNorm
    epsilon 1e-6; keys in sorted order."""
    rng = np.random.default_rng(8)
    n = 3
    lead = (4, n) if per_agent else (4,)
    obs = {"agents": rng.normal(size=lead + (n, 16)).astype(np.float32),
           "obstacles": rng.normal(size=lead + (5, 8)).astype(np.float32)}
    jm = (_TransformerActor(n, 4, per_agent) if role == "actor"
          else _TransformerCritic(n, per_agent))
    _check(jm, (jax.tree_util.tree_map(jnp.asarray, obs),),
           functools.partial(TransformerNet, obs, out_dim=4 if role == "actor" else 1, role=role,
                             n_agents=n, per_agent_obs=per_agent),
           (_t(obs),), out=(lambda d: d.mean) if role == "actor" else (lambda o: o))


def test_pointnet_matches_flax():
    rng = np.random.default_rng(9)
    obs = {"observation": rng.normal(size=(8, 1, 20)).astype(np.float32),
           "sdf_points": rng.normal(size=(8, 1, 64, 3)).astype(np.float32)}
    _check(_SDFNavActor(4), (jax.tree_util.tree_map(jnp.asarray, obs),),
           functools.partial(SDFNavNet, obs, out_dim=4, role="actor"), (_t(obs),),
           out=lambda d: d.mean)


class _GRUOnly(LeafNet):
    """`masked_gru`'s output (0) or new state (1)."""

    def __init__(self, d, h, output, leaves=None, generator=None):
        super().__init__()
        self.d, self.h, self.output = d, h, output
        self._make_flat(leaves, generator)

    def leaf_specs(self):
        return masked_gru_leaves("MaskedGRU_0", self.d, self.h)

    def forward(self, x, state, is_init):
        return masked_gru(self.params(), "MaskedGRU_0", x, state, is_init)[self.output]


@pytest.mark.parametrize("output", [0, 1])
def test_masked_gru_matches_flax(output):
    """The output and the new state, the state re-zeroed where is_init is
    set (on some rows), and the gradients through both."""
    import flax.linen as nn

    class Wrap(nn.Module):
        @nn.compact
        def __call__(self, x, h, ii):
            return JGRU(16, name="MaskedGRU_0")(x, h, ii)

    rng = np.random.default_rng(10 + output)
    x = rng.normal(size=(12, 2, 9)).astype(np.float32)
    h = rng.normal(size=(12, 2, 16)).astype(np.float32)
    ii = rng.uniform(size=(12, 2, 1)) < 0.4
    jargs = (jnp.asarray(x), jnp.asarray(h), jnp.asarray(ii))
    targs = (torch.as_tensor(x), torch.as_tensor(h), torch.as_tensor(ii))
    net = _check(Wrap(), jargs, functools.partial(_GRUOnly, 9, 16, output),
                 targs, out=lambda o: o[output])
    if output == 1:
        # rows with is_init set start from zeros: their new state ignores h
        s0 = net(*targs)
        s1 = net(targs[0], torch.zeros_like(targs[1]), targs[2])
        rows = torch.as_tensor(ii[..., 0])
        assert torch.equal(s0[rows], s1[rows]) and not torch.equal(s0[~rows], s1[~rows])
