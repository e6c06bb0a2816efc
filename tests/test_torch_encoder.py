"""The port's encoder + head (ops/fused_encoder.py) against the JAX package.

* Against `fused_encoder_head` / `fused_pair_encoder_head`, which off-TPU run
  `reference_apply`: the same math with the same bf16 rounding points, so the
  only differences are f32 summation order and the rare value that then
  rounds to the neighbouring bf16 number (2^-8 relative), which carries into
  the output.  Outputs are O(1) (unit-scale weights); the tolerance is
  5e-3 of the output's largest magnitude (measured: ~2e-3).
* Against the flax `Actor` mean and `Critic` value: flax computes the softmax
  in bf16 and the head in f32, so the tolerance is looser, 3e-2 relative to
  the output's scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.learning.mappo import MAPPOCfg as JCfg
from mupe_tpu.learning.mappo import MAPPOPolicy as JPolicy
from mupe_tpu.learning.modules.networks import entity_group_order as jorder
from mupe_tpu.ops import fused_encoder as jfe
from mupe_tpu_torch import bridge
from mupe_tpu_torch.learning.modules.networks import entity_group_order
from mupe_tpu_torch.ops import fused_encoder as tfe

torch.set_num_threads(1)
GROUPS = ((1, 35), (3, 5), (2, 3))
NAMES = ["state_self", "cylinders", "state_others"]
TIGHT = 5e-3


def _close_scaled(t, j, rel):
    j = np.asarray(j)
    np.testing.assert_allclose(np.asarray(t), j, atol=rel * np.abs(j).max(), rtol=0)


def _obs(rng, e, n=3):
    return {
        "state_self": rng.normal(0, 1, (e, n, 1, 35)).astype(np.float32),
        "cylinders": rng.normal(0, 1, (e, n, 3, 5)).astype(np.float32),
        "state_others": rng.normal(0, 0.5, (e, n, 2, 3)).astype(np.float32),
    }


def _unit_leaves(rng, spec):
    out = []
    for shape in tfe.leaf_shapes(spec):
        if len(shape) == 2:
            out.append((rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32))
        else:
            out.append((1.0 * (len(out) % 2 == 0) + 0.1 * rng.normal(size=shape)).astype(np.float32))
    return out


def _torch(leaves):
    return [torch.as_tensor(l) for l in leaves]


@pytest.mark.parametrize("s", [1, 64, 299, 1000])
def test_pair_forward_matches_jax_reference(s):
    rng = np.random.default_rng(s)
    spec_a = tfe.EncoderSpec(groups=GROUPS, head_dim=4)
    spec_c = tfe.EncoderSpec(groups=GROUPS, head_dim=1)
    la, lc = _unit_leaves(rng, spec_a), _unit_leaves(rng, spec_c)
    x = rng.normal(0, 2, (s, spec_a.obs_dim)).astype(np.float32)
    ja, jc = jfe.fused_pair_encoder_head(
        jfe.EncoderSpec(groups=GROUPS, head_dim=4), jfe.EncoderSpec(groups=GROUPS, head_dim=1),
        tuple(map(jnp.asarray, la)), tuple(map(jnp.asarray, lc)), jnp.asarray(x))
    ta, tc = tfe.encoder_pair_forward(spec_a, spec_c, _torch(la), _torch(lc), torch.as_tensor(x))
    assert np.abs(np.asarray(ja)).max() > 0.3  # O(1) outputs
    _close_scaled(ta, ja, TIGHT)
    _close_scaled(tc, jc, TIGHT)


def test_pair_forward_matches_jax_reference_at_16_tokens():
    """16 tokens over 148 columns (6 pursuers, 10 cylinder tokens, 21
    predicted steps): the kernels' 16-token instance on the card."""
    groups = ((1, 83), (10, 5), (5, 3))
    rng = np.random.default_rng(16)
    spec_a = tfe.EncoderSpec(groups=groups, head_dim=4)
    spec_c = tfe.EncoderSpec(groups=groups, head_dim=1)
    assert spec_a.n_tokens == 16 and tfe.kernel_spec_ok(spec_a)
    la, lc = _unit_leaves(rng, spec_a), _unit_leaves(rng, spec_c)
    x = rng.normal(0, 2, (33, spec_a.obs_dim)).astype(np.float32)
    ja, jc = jfe.fused_pair_encoder_head(
        jfe.EncoderSpec(groups=groups, head_dim=4), jfe.EncoderSpec(groups=groups, head_dim=1),
        tuple(map(jnp.asarray, la)), tuple(map(jnp.asarray, lc)), jnp.asarray(x))
    ta, tc = tfe.encoder_pair_forward(spec_a, spec_c, _torch(la), _torch(lc), torch.as_tensor(x))
    assert np.abs(np.asarray(ja)).max() > 0.3
    _close_scaled(ta, ja, TIGHT)
    _close_scaled(tc, jc, TIGHT)


def test_single_forward_matches_jax_reference():
    rng = np.random.default_rng(7)
    spec = tfe.EncoderSpec(groups=GROUPS, head_dim=1)
    leaves = _unit_leaves(rng, spec)
    x = rng.normal(0, 2, (200, spec.obs_dim)).astype(np.float32)
    j = jfe.fused_encoder_head(jfe.EncoderSpec(groups=GROUPS, head_dim=1),
                               tuple(map(jnp.asarray, leaves)), jnp.asarray(x))
    t = tfe.encoder_forward(spec, _torch(leaves), torch.as_tensor(x))
    _close_scaled(t, j, TIGHT)


@pytest.fixture(scope="module")
def flax_policy():
    rng = np.random.default_rng(11)
    obs = _obs(rng, 16)
    pol = JPolicy(JCfg(use_tp_net=False), n_agents=3, action_dim=4, obs_is_dict=True)
    ts = pol.init(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in obs.items()})
    return pol, ts, obs


def test_bridge_leaf_order_matches_extract_leaves(flax_policy):
    pol, ts, _ = flax_policy
    for params, head in ((ts.actor_params, 4), (ts.critic_params, 1)):
        jl = jfe.extract_leaves(jfe.EncoderSpec(groups=GROUPS, head_dim=head), params, NAMES)
        tl = bridge.encoder_leaves(jax.device_get(params))
        assert bridge.group_names(jax.device_get(params)) == NAMES
        assert len(tl) == len(jl) == 26
        for a, b in zip(tl, jl):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        spec = tfe.EncoderSpec(groups=GROUPS, head_dim=head)
        assert [tuple(l.shape) for l in tl] == list(tfe.leaf_shapes(spec))
    np.testing.assert_array_equal(
        bridge.actor_log_std(jax.device_get(ts.actor_params)).numpy(),
        np.asarray(ts.actor_params["params"]["DiagGaussianHead_0"]["log_std"]))


def test_port_matches_flax_actor_and_critic(flax_policy):
    pol, ts, obs = flax_policy
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    mean = np.asarray(pol.actor.apply(ts.actor_params, jobs).mean)
    value = np.asarray(pol.critic.apply(ts.critic_params, jobs))
    spec_a = tfe.EncoderSpec(groups=GROUPS, head_dim=4)
    spec_c = tfe.EncoderSpec(groups=GROUPS, head_dim=1)
    x, lead = tfe.pack_obs(spec_a, bridge.tensors(obs), NAMES)
    ta, tc = tfe.encoder_pair_forward(
        spec_a, spec_c, bridge.encoder_leaves(jax.device_get(ts.actor_params)),
        bridge.encoder_leaves(jax.device_get(ts.critic_params)), x)
    for t, j in ((ta.reshape(lead + (4,)), mean), (tc.reshape(lead + (1,)), value)):
        assert np.abs(j).max() > 0
        _close_scaled(t, j, 3e-2)


def test_pack_obs_and_group_order_match_jax():
    rng = np.random.default_rng(5)
    obs = _obs(rng, 4)
    for keys in (list(obs), ["state_others", "cylinders", "state_self"],
                 ["cylinders", "state_self", "state_others"]):
        assert entity_group_order(keys) == jorder(keys) == NAMES
    spec = tfe.EncoderSpec(groups=GROUPS, head_dim=4)
    jx, jlead = jfe.pack_obs(jfe.EncoderSpec(groups=GROUPS, head_dim=4),
                             {k: jnp.asarray(v) for k, v in obs.items()}, NAMES)
    tx, tlead = tfe.pack_obs(spec, bridge.tensors(obs), NAMES)
    assert tuple(tlead) == tuple(jlead) == (4, 3)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert spec.obs_dim == 56 and spec.n_tokens == 6 and spec.n_leaves == 26


def test_reference_rounds_like_forward_core():
    """The embeds, k and v are bf16 values; a perturbation below bf16
    resolution of an input to a rounded operand leaves the output as is."""
    rng = np.random.default_rng(9)
    spec = tfe.EncoderSpec(groups=GROUPS, head_dim=4)
    leaves = _torch(_unit_leaves(rng, spec))
    x = torch.as_tensor(rng.normal(0, 2, (32, 56)).astype(np.float32))
    x = x.to(torch.bfloat16).float()
    out = tfe.reference_apply(spec, leaves, x)
    nudged = x * (1 + 2.0**-12)  # rounds back to the same bf16 value
    assert torch.equal(tfe.reference_apply(spec, leaves, nudged), out)
