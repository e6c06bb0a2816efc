"""The critic's decoupled weight decay (`MAPPOCfg.weight_decay`) in the
PyTorch port against the JAX package's optimizer.

The JAX package steps the critic with `optax.flatten(chain(
clip_by_global_norm(max_grad_norm), adamw(critic_lr, weight_decay)))` where
`weight_decay > 0` (mupe_tpu/learning/mappo.py:346-359): update = -lr (m_hat /
(sqrt(v_hat) + eps) + wd p), on every critic leaf, after the clip.  The actor
and the TP net keep plain Adam.

* The optimizer alone against optax, several steps from identical
  gradients, clipped and not: within 1e-6 relative (1e-6 of the scale where
  a moment cancels), as tests/test_torch_update.py holds Adam.
* A whole `train_op` on each update path -- the default joint update
  (`_update_joint_flat`), the in-kernel loss (`_update_joint_direct`,
  fwdloss) and the flat path (`_update_critic`) -- with weight_decay 0.01:
  every gradient the port's critic step is given is replayed through the
  JAX policy's own `critic_tx` from the same initial parameters; the
  port's critic and its Adam moments must equal the replay's within 1e-6
  of their scale (the global norm sums in another order).  The gradients
  themselves are held against JAX's in tests/test_torch_update.py,
  test_torch_inkernel_loss.py and test_torch_flat_mappo.py (where a whole
  flat `train_op` with weight_decay 0.5 is also held against JAX's).
* weight_decay 0.0 and 0.5 give different critics and the same actor.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mupe_tpu.learning.mappo import MAPPOCfg as JCfg
from mupe_tpu.learning.mappo import MAPPOPolicy as JPolicy
from mupe_tpu_torch.envs import HideAndSeek, HideAndSeekCfg, Hover, HoverCfg
from mupe_tpu_torch.learning import AdamState, MAPPOCfg, MAPPOPolicy, init_carry, make_rollout
from mupe_tpu_torch.learning import make_train_iter
from mupe_tpu_torch.learning.optim import adam_updates, clip_by_global_norm

torch.set_num_threads(1)
WD = 0.01
PATHS = {"default": dict(obs_is_dict=True),
         "fwdloss": dict(obs_is_dict=True, use_inkernel_loss=True, direct_mode="fwdloss"),
         "flat": dict(obs_is_dict=False)}


@pytest.mark.parametrize("scale", [0.01, 30.0])
@pytest.mark.parametrize("wd", [WD, 0.5])
def test_adamw_matches_optax(scale, wd):
    """Several steps of clip-by-global-norm(10) + AdamW on one parameter
    vector, the parameters moving between steps; scale 30 makes the clip
    bite."""
    rng = np.random.default_rng(int(scale * 100))
    p = rng.normal(size=(2000,)).astype(np.float32)
    tx = optax.flatten(optax.chain(optax.clip_by_global_norm(10.0),
                                   optax.adamw(5e-4, weight_decay=wd)))
    jp, jstate = jnp.asarray(p), tx.init(jnp.asarray(p))
    tp, tstate = torch.as_tensor(p), AdamState.zeros_like([torch.as_tensor(p)])
    for _ in range(4):
        g = (scale * rng.normal(size=p.shape)).astype(np.float32)
        jupd, jstate = tx.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, jupd)
        (tupd,), tstate = adam_updates(clip_by_global_norm([torch.as_tensor(g)], 10.0), tstate,
                                       5e-4, weight_decay=wd, params=[tp])
        tp = tp + tupd
        np.testing.assert_allclose(tupd.numpy(), np.asarray(jupd), rtol=1e-6, atol=1e-6 * 5e-4)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    adam = jstate[1][0]
    np.testing.assert_allclose(tstate.mu[0].numpy(), np.asarray(adam.mu), rtol=1e-6,
                               atol=1e-6 * float(np.abs(adam.mu).max()))
    np.testing.assert_allclose(tstate.nu[0].numpy(), np.asarray(adam.nu), rtol=1e-6, atol=1e-15)


def test_no_decay_is_plain_adam():
    """weight_decay 0 takes no decay term: the update is optax.adam's."""
    g, p = torch.randn(50), torch.randn(50)
    a, _ = adam_updates([g], AdamState.zeros_like([p]), 5e-4)
    b, _ = adam_updates([g], AdamState.zeros_like([p]), 5e-4, weight_decay=0.0, params=[p])
    assert torch.equal(a[0], b[0])


def _setup(path, weight_decay, e=16, steps=8):
    """A tiny env, the port's policy on the CPU, a carry and a CPU rollout."""
    kw = dict(PATHS[path])
    obs_is_dict = kw.pop("obs_is_dict")
    cfg = MAPPOCfg(train_every=steps, num_minibatches=2, ppo_epochs=2, weight_decay=weight_decay,
                   hidden_units=(64, 64), **kw)
    if obs_is_dict:
        env = HideAndSeek(HideAndSeekCfg(num_envs=e, max_episode_length=800, use_tp_net=False),
                          device="cpu")
    else:
        env = Hover(HoverCfg(num_envs=e, max_episode_length=6), device="cpu")
    pol = MAPPOPolicy(cfg, n_agents=env.num_agents, action_dim=4, obs_is_dict=obs_is_dict,
                      device="cpu")
    return env, pol, init_carry(env, pol, torch.Generator().manual_seed(3))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_critic_step_replays_through_jaxs_adamw(path):
    """A whole `train_op` with weight_decay 0.01 on each update path; the
    critic against the JAX policy's `critic_tx` fed the same gradients."""
    env, pol, carry = _setup(path, WD)
    with torch.no_grad():  # the head at unit gain: every term of the loss moves
        carry.ts.critic.leaves[-2].mul_(100.0)
    _, traj, _ = make_rollout(env, pol)(carry)
    start = carry.ts.critic.flat.detach().clone()
    seen = []
    step = pol._critic_step

    def recording(ts, gc, stop):
        seen.append(gc[0].detach().clone())
        step(ts, gc, stop)

    pol._critic_step = recording
    ts, _ = pol.train_op(carry.ts, traj, carry.obs, torch.Generator().manual_seed(4))
    assert len(seen) == 4
    replays = {}
    for wd in (WD, 0.0):
        jtx = JPolicy(JCfg(weight_decay=wd), 1, 4, obs_is_dict=False).critic_tx
        jp = {"flat": jnp.asarray(start.numpy())}
        state = jtx.init(jp)
        for g in seen:
            upd, state = jtx.update({"flat": jnp.asarray(g.numpy())}, state, jp)
            jp = optax.apply_updates(jp, upd)
        replays[wd] = (np.asarray(jp["flat"]), state)
    (want, state), (plain, _) = replays[WD], replays[0.0]
    got = ts.critic.flat.detach().numpy()
    atol = 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    # the decay is visible: about 4 lr wd |p| from the plain-Adam replay
    assert np.abs(got - plain).max() > 10 * atol
    adam = jax.tree_util.tree_leaves(state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
    adam = next(a for a in adam if isinstance(a, optax.ScaleByAdamState))
    mu, nu = np.asarray(adam.mu), np.asarray(adam.nu)  # optax.flatten's raveled moments
    np.testing.assert_allclose(ts.critic_opt.mu[0].numpy(), mu, rtol=0,
                               atol=1e-6 * np.abs(mu).max())
    np.testing.assert_allclose(ts.critic_opt.nu[0].numpy(), nu, rtol=1e-5,
                               atol=1e-6 * np.abs(nu).max())
    assert int(ts.critic_opt.count) == int(adam.count) == 4


@pytest.mark.parametrize("path", ["default", "flat"])
def test_weight_decay_changes_the_critic_alone(path):
    """One training iteration from the same seed at weight_decay 0.0 and
    0.5: the critics differ, the actors are the same bits (the advantages
    are computed before the update, and the actor keeps plain Adam)."""
    out = {}
    for wd in (0.0, 0.5):
        env, pol, carry = _setup(path, wd)
        carry, _, _ = make_train_iter(env, pol)(carry)
        out[wd] = carry.ts
    diff = (out[0.0].critic.flat - out[0.5].critic.flat).detach().abs().max()
    assert float(diff) > 1e-5
    assert torch.equal(out[0.0].actor.flat, out[0.5].actor.flat)
    assert torch.equal(out[0.0].log_std, out[0.5].log_std)
