"""The slice end to end: the port's `init_carry` + rollout against the JAX
package's `rollout_prog`, from the same converted env state and parameters.

The JAX policy runs with `use_fused_act=True`, so its `act` is the pair
kernel's math (`reference_apply` off-TPU), and the JAX env predicts the
evader through `tp_apply_t`, the TP kernel's math.  The actor and critic
heads are scaled to unit gain so actions and values are O(1).

Tolerances, relative to each output's largest magnitude:
* the port's `act` against JAX's eager `act`: 2e-3 (measured ~7e-4; the
  port's plain version agrees with a float64 evaluation of the same bf16
  rounding points to ~1e-7, so this is the JAX side's f32 rounding);
* the port's rollout against JAX's compiled `rollout_prog`: 3e-2 for values
  and actions.  On this CPU the compiled program's encoder already differs
  from JAX's own eager `act` by ~1% of the output scale at the first step
  (measured 1.0e-2 of 1.2), before any state diverges.  Observations,
  which the free-running rollout feeds back, agree to atol 1e-2 (measured
  2e-3, TP-derived parts) and rewards to atol 1e-3 (measured 4e-5 on a
  scale of 100; a collision or capture flip would cost 20 or more).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.envs.hideandseek import HideAndSeekCfg as JEnvCfg
from mupe_tpu.learning.mappo import MAPPOCfg as JCfg
from mupe_tpu.learning.mappo import MAPPOPolicy as JPolicy
from mupe_tpu.learning.modules.distributions import Gaussian as JGaussian
from mupe_tpu.learning.rollout import init_carry as jinit_carry
from mupe_tpu.learning.rollout import make_rollout_update_progs
from mupe_tpu_torch import bridge
from mupe_tpu_torch.envs import HideAndSeek, HideAndSeekCfg, tree_to
from mupe_tpu_torch.learning import MAPPOCfg, MAPPOPolicy, init_carry, make_rollout
from mupe_tpu_torch.learning.modules.distributions import Gaussian
from test_torch_hideandseek import KernelTPEnv, to_np

torch.set_num_threads(1)
E = 8
STEPS = 6
EAGER_REL = 2e-3
ROLLOUT_REL = 3e-2


def _close_scaled(t, j, rel, what=""):
    j = np.asarray(j)
    np.testing.assert_allclose(np.asarray(t), j, atol=rel * np.abs(j).max(), rtol=0,
                               err_msg=what)


@pytest.fixture(scope="module")
def slice_pair():
    jenv = KernelTPEnv(JEnvCfg(num_envs=E, max_episode_length=800))
    jpol = JPolicy(JCfg(train_every=STEPS, use_tp_net=True, use_fused_act=True,
                        pack_rollout=False),
                   n_agents=3, action_dim=4, obs_is_dict=True, tp_input_dim=16)
    jcarry = jinit_carry(jenv, jpol, jax.random.PRNGKey(0))
    # heads at unit gain (initialised at 0.01) so actions and values are O(1)
    # and drive the drones, and a non-zero log_std
    params = jcarry.ts.actor_params
    head = params["params"]["DiagGaussianHead_0"]
    head["Dense_0"]["kernel"] = head["Dense_0"]["kernel"] * 100.0
    head["log_std"] = jnp.asarray([0.1, -0.2, 0.3, -0.4])
    critic = jcarry.ts.critic_params["params"]["Dense_0"]
    critic["kernel"] = critic["kernel"] * 100.0

    tenv = HideAndSeek(HideAndSeekCfg(num_envs=E, max_episode_length=800), device="cpu")
    tpol = MAPPOPolicy(MAPPOCfg(train_every=STEPS, use_tp_net=True), n_agents=3,
                       action_dim=4, obs_is_dict=True, tp_input_dim=16, device="cpu")
    env_state = bridge.env_state(to_np(jcarry.env_state))
    obs = bridge.tensors(to_np(jcarry.obs))
    ts = bridge.policy_state(tpol, obs, jax.device_get(params),
                             jax.device_get(jcarry.ts.critic_params),
                             jax.device_get(jcarry.ts.tp_params))
    tcarry = init_carry(tenv, tpol, torch.Generator().manual_seed(0), ts=ts,
                        env_state=env_state)
    return jenv, jpol, jcarry, tenv, tpol, tcarry


def test_init_carry_observation_matches_jax(slice_pair):
    _, _, jcarry, _, _, tcarry = slice_pair
    for k, v in to_np(jcarry.obs).items():
        np.testing.assert_allclose(tcarry.obs[k].numpy(), v, atol=2e-3, err_msg=k)


def test_deterministic_rollout_matches_jax(slice_pair):
    jenv, jpol, jcarry, tenv, tpol, tcarry = slice_pair
    rollout_prog, _ = make_rollout_update_progs(jenv, jpol, deterministic=True)
    _, jtraj, jstats = rollout_prog(jcarry)
    _, ttraj, tstats = make_rollout(tenv, tpol, deterministic=True)(tcarry)
    jt = to_np(jtraj)
    for k in ("value", "reward", "action", "logp", "tp_input", "tp_gt", "done", "tp_done"):
        assert ttraj[k].shape == jt[k].shape, k
    _close_scaled(ttraj["value"], jt["value"], ROLLOUT_REL, "value")
    _close_scaled(ttraj["action"], jt["action"], ROLLOUT_REL, "action")
    np.testing.assert_allclose(ttraj["reward"].numpy(), jt["reward"], atol=1e-3)
    for k in ("done", "tp_done"):
        np.testing.assert_array_equal(ttraj[k].numpy(), jt[k], err_msg=k)
    for k in ("tp_input", "tp_gt"):
        np.testing.assert_allclose(ttraj[k].numpy(), jt[k], atol=1e-2, err_msg=k)
    for k, v in jt["obs"].items():
        np.testing.assert_allclose(ttraj["obs"][k].numpy(), v, atol=1e-2, err_msg=k)
    assert set(tstats) == set(to_np(jstats))
    assert float(tstats["episode_count"]) == float(jstats["episode_count"]) == 0.0
    assert np.abs(jt["value"]).max() > 0 and np.abs(jt["reward"]).max() > 0


def test_logp_of_injected_actions_matches_jax(slice_pair):
    _, jpol, jcarry, _, tpol, tcarry = slice_pair
    rng = np.random.default_rng(1)
    mean, _, jvalue = jpol.act(jcarry.ts, jcarry.obs, jax.random.PRNGKey(0), deterministic=True)
    log_std = jcarry.ts.actor_params["params"]["DiagGaussianHead_0"]["log_std"]
    jdist = JGaussian(mean=mean, log_std=jnp.broadcast_to(log_std, mean.shape))
    actions = rng.normal(0, 1, mean.shape).astype(np.float32)
    jlogp = np.asarray(jdist.log_prob(jnp.asarray(actions)))
    tmean, _, tvalue = tpol.act(tcarry.ts, tcarry.obs, deterministic=True)
    tdist = Gaussian(mean=tmean, log_std=tcarry.ts.log_std.expand(tmean.shape))
    tlogp = tdist.log_prob(torch.as_tensor(actions)).numpy()
    _close_scaled(tlogp, jlogp, EAGER_REL, "logp")
    _close_scaled(tmean, mean, EAGER_REL, "mean")
    _close_scaled(tvalue, jvalue, EAGER_REL, "value")
    np.testing.assert_allclose(tdist.entropy().numpy(), np.asarray(jdist.entropy()), rtol=1e-6)


def test_stochastic_act_with_injected_noise_matches_jax(slice_pair):
    _, jpol, jcarry, _, tpol, tcarry = slice_pair
    mean, _, _ = jpol.act(jcarry.ts, jcarry.obs, jax.random.PRNGKey(0), deterministic=True)
    log_std = jcarry.ts.actor_params["params"]["DiagGaussianHead_0"]["log_std"]
    noise = np.random.default_rng(2).normal(size=mean.shape).astype(np.float32)
    jdist = JGaussian(mean=mean, log_std=jnp.broadcast_to(log_std, mean.shape))
    jaction = mean + jdist.std * jnp.asarray(noise)  # Gaussian.sample with this draw
    jlogp = np.asarray(jdist.log_prob(jaction))[..., None]
    taction, tlogp, _ = tpol.act(tcarry.ts, tcarry.obs, noise=torch.as_tensor(noise))
    _close_scaled(taction, jaction, EAGER_REL, "action")
    # log p of a sample depends on the noise alone: −½ε² − log σ − log √2π
    np.testing.assert_allclose(tlogp.numpy(), jlogp, rtol=1e-5, atol=1e-4)
    g = torch.Generator().manual_seed(0)
    a1, _, _ = tpol.act(tcarry.ts, tcarry.obs, g)
    assert not torch.equal(a1, taction) and torch.isfinite(a1).all()


def test_value_op_and_short_episodes_run_the_port(slice_pair):
    """value_op on the last observation, and a rollout through auto-reset."""
    _, jpol, jcarry, _, tpol, tcarry = slice_pair
    jv = jpol.value_op(jcarry.ts, jcarry.obs, fused=True)
    tv = tpol.value_op(tcarry.ts, tcarry.obs)
    _close_scaled(tv, jv, EAGER_REL, "value_op")
    env = HideAndSeek(HideAndSeekCfg(num_envs=4, max_episode_length=3), device="cpu")
    carry = init_carry(env, tpol, torch.Generator().manual_seed(5))
    carry, traj, stats = make_rollout(env, tpol)(carry, 7)
    assert traj["done"][:, 0, 0].tolist() == [0, 0, 1, 0, 0, 1, 0]
    assert float(stats["episode_count"]) == 8.0
    assert all(torch.isfinite(v).all() for v in traj.values() if isinstance(v, torch.Tensor))
    assert tree_to(carry.obs, "cpu")["state_self"].shape == (4, 3, 1, 35)
