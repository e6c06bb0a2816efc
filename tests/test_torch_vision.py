"""The vision path of the PyTorch port against the JAX package on the CPU:
`ConvVisionEncoder` (TensorFlow-style "SAME" padding at Hover's 24 x 32
frame, at JAX's own tests' 12 x 16 and at an odd 13 x 17), MobileNetV3-Small
(forward and gradients at 13 x 17) and -Large (forward), `_BatchStatsNorm`'s
biased variance, `MixedObsEncoder` on a dict whose keys are not in sorted
order (against the jitted JAX apply, which sees them sorted), the analytic
depth camera with every primitive, one `act` and one `train_op` of
ppo_vision with each small backbone, and `harness.train` of ppo_vision.

MobileNet's parameters are made by the port (`init_leaf`) and handed to
flax as a tree (`_flax_tree`, the bridge's inverse): flax's `init` of the
backbone costs more to compile than the checks themselves.

Tolerances.  float32 (JAX's side jitted): values and gradients within 1e-5
of each tensor's largest magnitude, but MobileNet's: its batch-statistics
norms over a few frames (at 1 x 1 pixels late in the network) amplify the
rounding of the two libraries' convolutions; JAX's own float32 output sat
2.0e-5 of its scale from the port's float64 at 12 x 16 and 6 frames (the
port's float32 1.0e-5), and its gradients up to 1.2e-5, so the port's
float32 and float64 are each held within 1e-4 of the scale of JAX's float32
(JAX has no float64 reference: its norms cast to float32), a leaf whose
gradient is rounding noise to the network's largest gradient.  The depth camera: the
port within 1e-5 relative of JAX on every pixel whose ray does not graze a
primitive (a ray within rounding of tangent to a cylinder or the sphere
can flip between hit and miss, or its root move by the cancellation in the
discriminant); such pixels, found as those where the port's float32 and
float64 casts part by more than 1e-5 relative, are counted and must stay
under 1% (1 of this scene's 6,144).  The ppo_vision updates as tests/test_torch_rma.py's.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.learning.mappo import MAPPOCfg as JCfg
from mupe_tpu.learning.mappo import MAPPOPolicy as JPolicy
from mupe_tpu.learning.mappo import MAPPOState as JState
from mupe_tpu.learning.mappo import RolloutBatch
from mupe_tpu.learning.modules import mobilenet as jmb
from mupe_tpu.learning.modules import networks as jn
from mupe_tpu.learning.valuenorm import ValueNorm1 as JValueNorm1
from mupe_tpu.sensors import depth as jdepth
from mupe_tpu_torch import bridge, harness
from mupe_tpu_torch.learning.mappo import net_flats
from mupe_tpu_torch.learning.modules import mobilenet as tmb
from mupe_tpu_torch.learning.modules import networks as tn
from mupe_tpu_torch.learning.registry import make_policy
from mupe_tpu_torch.envs import Hover, HoverCfg
from mupe_tpu_torch.sensors import depth as tdepth
from test_torch_rma import ACT_METRIC_REL, FLIP_SHARE, LR, _close, _hold_module, _Net, _np, _t

torch.set_num_threads(1)
T, E, A, D = 4, 4, 4, 20


def _flax_tree(specs, leaves, prefix=None):
    """The port's leaves as a flax tree {"params": ...} (the inverse of
    `bridge.named_leaves`: flax's layout restored where a leaf has `perm`),
    rooted at `prefix` where given."""
    tree = {}
    for leaf, v in zip(specs, leaves):
        a = np.array(v.detach())
        if leaf.perm is not None:
            a = np.transpose(a, np.argsort(leaf.perm))
        node = tree
        *parents, name = leaf.path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = jnp.asarray(a)
    return {"params": tree[prefix] if prefix else tree}


def _perturbed_leaves(specs, seed):
    """flax's initial values with the norms' scales and biases moved off
    their defaults, so that every leaf moves the output."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for leaf in specs:
        v = tn.init_leaf(leaf, gen)
        if leaf.init in ("ones", "zeros"):
            v = v + 0.2 * torch.randn(leaf.shape, generator=gen)
        out.append(v)
    return out


# ------------------------------------------------------------------ conv encoder
@pytest.mark.parametrize("hw", [(24, 32), (12, 16), (13, 17)], ids=["24x32", "12x16", "13x17"])
def test_conv_encoder_matches_flax(hw):
    """Every convolution is 3x3 at stride 2 with flax's default "SAME"
    padding: at an even size the odd pad unit goes at the end (a symmetric
    pad of 1 would part from flax by O(1)); at an odd size no pad is odd."""
    x = np.random.default_rng(0).normal(size=(5, 2) + hw + (1,)).astype(np.float32)
    enc = tn.ConvVisionEncoder("enc")
    _hold_module(jn.ConvVisionEncoder(), (x,), "enc", enc.leaf_specs(1), enc)


def test_same_pads_are_tensorflows():
    """low = total // 2 of total = max((ceil(n / s) - 1) s + k - n, 0)."""
    assert tn.same_pads(24, 3, 2) == (0, 1) and tn.same_pads(32, 3, 2) == (0, 1)
    assert tn.same_pads(13, 3, 2) == (1, 1) and tn.same_pads(12, 5, 1) == (2, 2)
    assert tn.same_pads(7, 5, 2) == (2, 2) and tn.same_pads(1, 3, 2) == (1, 1)
    assert tn.same_pads(2, 1, 2) == (0, 0)


# ------------------------------------------------------------------ MobileNet
def _mobilenet(variant, x, seed):
    mod = tmb.MobileNetV3("enc", variant)
    specs = mod.leaf_specs(x.shape[-1])
    leaves = _perturbed_leaves(specs, seed)
    return mod, specs, dict(zip([l.path for l in specs], leaves)), jmb.MobileNetV3(variant=variant)


MOBILENET_REL = 1e-4


def _hold_mobilenet(what, got32, got64, want32, scale=None):
    """The port's float32 and its float64 each within 1e-4 of `scale` (the
    tensor's largest magnitude by default) of JAX's float32 (whose
    batch-statistics norms cast to float32 whatever the input, so JAX has no
    float64 reference)."""
    want32 = np.asarray(want32, np.float64)
    scale = np.abs(want32).max() if scale is None else scale
    for tag, got in (("f32", got32), ("f64", got64)):
        err = np.abs(_np(got).astype(np.float64) - want32.reshape(got.shape)).max()
        assert err <= MOBILENET_REL * scale, (what, tag, err / scale)


def test_mobilenet_small_matches_flax():
    """Forward and gradients (parameters and frames) at an odd 13 x 17
    frame, 8 one-channel frames repeated to three."""
    x = np.random.default_rng(1).normal(size=(2, 4, 13, 17, 1)).astype(np.float32)
    mod, specs, p, jmod = _mobilenet("small", x, 2)
    params = _flax_tree(specs, p.values(), "enc")
    cot = np.random.default_rng(3).normal(size=(2, 4, 576)).astype(np.float32)

    def loss(q, x_, c):
        out = jmod.apply(q, x_)
        return jnp.sum(out * c), out

    r32 = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(params, x, cot)

    def port(dtype):
        tp = {k: v.to(dtype).requires_grad_(True) for k, v in p.items()}
        xt = torch.tensor(x, dtype=dtype, requires_grad=True)
        out = mod(tp, xt)
        return out, torch.autograd.grad(torch.sum(out * torch.as_tensor(cot, dtype=dtype)),
                                        [xt, *tp.values()])

    (o32, g32), (o64, g64) = port(torch.float32), port(torch.float64)
    _hold_mobilenet("output", o32, o64, r32[0][1])
    gp, gx = r32[1]
    want = [np.asarray(gx)] + [np.transpose(np.asarray(_path(gp["params"], l.path[4:])), l.perm)
                               if l.perm else np.asarray(_path(gp["params"], l.path[4:]))
                               for l in specs]
    # a leaf whose gradient is rounding noise (below 1e-6 of the network's
    # largest: a norm's bias whose shift the next norm removes, through a
    # ReLU that passes it and a 1x1 projection) is held to the network's scale
    net_scale = max(np.abs(w).max() for w in want[1:])
    for name, a32, a64, w in zip(["frames"] + [l.path for l in specs], g32, g64, want):
        noise = np.abs(w).max() < 1e-6 * net_scale
        _hold_mobilenet(name, a32, a64, w, net_scale if noise else None)


def _path(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def test_mobilenet_large_forward_matches_flax():
    x = np.random.default_rng(4).normal(size=(6, 24, 32, 1)).astype(np.float32)
    mod, specs, p, jmod = _mobilenet("large", x, 5)
    want = jax.jit(jmod.apply)(_flax_tree(specs, p.values(), "enc"), x)
    out = mod(p, torch.as_tensor(x))
    assert out.shape == (6, 960)
    out64 = mod({k: v.double() for k, v in p.items()}, torch.as_tensor(x).double())
    _hold_mobilenet("output", out, out64, want)


def test_batch_stats_norm_uses_the_biased_variance():
    """Statistics over N, H, W of the current call, var = mean((x - mean)^2)
    (jnp.var), eps 1e-3: held to JAX's, and an unbiased variance (torch's
    default) is told apart."""
    x = (np.random.default_rng(6).normal(size=(3, 2, 2, 5)) * 4 + 1).astype(np.float32)
    scale = np.random.default_rng(7).uniform(0.5, 1.5, 5).astype(np.float32)
    bias = np.random.default_rng(8).normal(size=5).astype(np.float32)
    jout = jax.jit(jmb._BatchStatsNorm().apply)({"params": {"scale": scale, "bias": bias}}, x)
    xt = torch.as_tensor(x).permute(0, 3, 1, 2)
    p = {"n/scale": torch.as_tensor(scale), "n/bias": torch.as_tensor(bias)}
    out = tmb._batch_stats_norm(p, "n", xt).permute(0, 2, 3, 1)
    _close(out, jout, "biased")
    mean = xt.mean(dim=(0, 2, 3), keepdim=True)
    unbiased = (xt - mean) / torch.sqrt(xt.var(dim=(0, 2, 3), keepdim=True) + 1e-3)
    unbiased = (unbiased * p["n/scale"][:, None, None] + p["n/bias"][:, None, None])
    assert np.abs(_np(unbiased.permute(0, 2, 3, 1)) - np.asarray(jout)).max() > 1e-2


# ------------------------------------------------------------------ mixed encoder
def test_mixed_obs_encoder_sorts_keys_as_jitted_jax():
    """{"observation", "depth"} in that (unsorted) order: the jitted flax
    module sees {"depth", "observation"} and concatenates the vision branch
    first; the port does the same, where the eager flax module would not."""
    rng = np.random.default_rng(9)
    obs = {"observation": rng.normal(size=(6, 1, D)).astype(np.float32),
           "depth": rng.uniform(size=(6, 1, 12, 16, 1)).astype(np.float32)}
    jmod = jn.MixedObsEncoder(vision_keys=("depth",))
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), obs)
    enc = tn.MixedObsEncoder("MixedObsEncoder_0")
    specs = enc.leaf_specs({k: torch.as_tensor(v) for k, v in obs.items()})
    p = dict(zip([l.path for l in specs], bridge.named_leaves(
        {"params": {"MixedObsEncoder_0": params["params"]}}, _Net(specs))))
    out = enc(p, {k: torch.as_tensor(v) for k, v in obs.items()})
    _close(out, jax.jit(jmod.apply)(params, obs), "jitted")
    eager = np.asarray(jmod.apply(params, obs))
    assert np.abs(_np(out) - eager).max() > 1e-2  # the insertion order differs


# ------------------------------------------------------------------ depth camera
def test_depth_image_matches_jax_with_every_primitive():
    rng = np.random.default_rng(10)
    n = 32
    cfg = dict(width=16, height=12, max_range=8.0)
    pos = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(0.3, 2.5, n)],
                   -1).astype(np.float32)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    cyl = rng.uniform(-2, 2, (n, 6, 3)).astype(np.float32)
    cyl[..., 2] = np.where(rng.uniform(size=(n, 6)) < 0.3, -1.0, 0.0)  # some parked
    tgt = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    kw = dict(arena_size=3.0, max_height=3.0, target_radius=0.25)
    want = np.asarray(jax.jit(lambda *a: jdepth.depth_image(
        jdepth.DepthCameraCfg(**cfg), a[0], a[1], cylinders=a[2], target_pos=a[3], **kw))(
        pos, quat, cyl, tgt))

    def port(dtype):
        c = tdepth.DepthCameraCfg(**cfg)
        rays = torch.as_tensor(tdepth.pinhole_rays(c)).to(dtype)
        return tdepth.depth_image(c, *(torch.as_tensor(a).to(dtype) for a in (pos, quat)),
                                  cylinders=torch.as_tensor(cyl).to(dtype),
                                  target_pos=torch.as_tensor(tgt).to(dtype), rays=rays,
                                  **kw).double().numpy()

    got, ref = port(torch.float32), port(torch.float64)
    np.testing.assert_array_equal(tdepth.pinhole_rays(tdepth.DepthCameraCfg(**cfg)),
                                  jdepth.pinhole_rays(jdepth.DepthCameraCfg(**cfg)))
    assert got.shape == want.shape == (n, 12, 16)
    grazing = np.abs(got - ref) > 1e-5 * np.abs(ref)
    assert grazing.mean() < 0.01, grazing.sum()
    ok = ~grazing
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=0)
    # every primitive shows (each nearer than the ground alone somewhere);
    # the frame lies within [min_range, max_range]
    def alone(**extra):
        return np.asarray(jdepth.depth_image(jdepth.DepthCameraCfg(**cfg), pos, quat, **extra))

    ground = alone()
    for extra in (dict(max_height=3.0), dict(arena_size=3.0),
                  dict(cylinders=cyl, max_height=3.0), dict(target_pos=tgt, target_radius=0.25)):
        assert (alone(**extra) < ground).any(), list(extra)
    assert want.min() >= 0.02 and want.max() <= 8.0


# ------------------------------------------------------------------ ppo_vision
def _vision_policies(kind):
    cfg = dict(train_every=T, num_minibatches=2, ppo_epochs=1)
    jpol = JPolicy(JCfg(use_fused_encoder=False, **cfg), 1, A, obs_is_dict=True,
                   actor_module=jn.VisionActor(action_dim=A, vision_encoder=kind),
                   critic_module=jn.VisionCritic(vision_encoder=kind))
    env = Hover(HoverCfg(num_envs=E, obs_depth=True, depth_width=16, depth_height=12),
                device="cpu")
    return jpol, make_policy("ppo_vision", env, dict(cfg, vision_encoder=kind), "cpu")


def _unit_heads(ts):
    """Heads at unit gain (x100) and a non-zero log_std."""
    with torch.no_grad():
        for net in (ts.actor, ts.critic):
            net.leaves[-2].mul_(100.0)
        ts.log_std.add_(torch.tensor([0.1, -0.2, 0.3, -0.4]))


@pytest.mark.parametrize("kind", ["conv", "mobilenet_v3_small"])
def test_ppo_vision_act_and_train_op_match_jax(kind):
    """From the port's initial parameters (norms perturbed, heads at unit
    gain) handed to flax; JAX's noise and permutations injected."""
    rng = np.random.default_rng(11)

    def obs_at(lead):  # Hover's insertion order, not sorted
        return {"observation": rng.normal(size=lead + (1, D)).astype(np.float32),
                "depth": rng.uniform(size=lead + (1, 12, 16, 1)).astype(np.float32)}

    obs, last_obs = obs_at((T, E)), obs_at((E,))
    jpol, tpol = _vision_policies(kind)
    ts = tpol.init(_t(last_obs), torch.Generator().manual_seed(12))
    for net, seed in ((ts.actor, 13), (ts.critic, 14)):
        with torch.no_grad():
            net.flat.copy_(torch.cat([l.reshape(-1) for l in _perturbed_leaves(
                net.leaf_specs(), seed)]))
    _unit_heads(ts)
    ap = _flax_tree(ts.actor.leaf_specs(), ts.actor.leaves)
    ap["params"]["DiagGaussianHead_0"]["log_std"] = jnp.asarray(_np(ts.log_std))
    cp = _flax_tree(ts.critic.leaf_specs(), ts.critic.leaves)
    jts = JState(actor_params=ap, critic_params=cp, actor_opt=jpol.actor_tx.init(ap),
                 critic_opt=jpol.critic_tx.init(cp), value_norm=JValueNorm1.create((1,)),
                 tp_params=None, tp_opt=None, entropy_coef=None)
    key = jax.random.PRNGKey(5)
    jact = jax.jit(lambda t_, o: jpol.act(t_, o, key))(jts, obs)
    noise = torch.as_tensor(np.array(jax.random.normal(key, jact[0].shape)))
    tact = tpol.act(ts, _t(obs), noise=noise)
    for j, t in zip(jact, tact):
        if kind == "conv":
            _close(t, j, "act")
        else:  # MobileNet's batch statistics: the floor of the forward test
            assert np.abs(_np(t) - np.asarray(j)).max() <= 1e-4 * max(np.abs(j).max(), 1.0)
    action, logp, value = jact
    batch = RolloutBatch(obs=obs, action=action, logp=logp, value=value,
                         reward=jnp.asarray(rng.normal(size=(T, E, 1, 1)).astype(np.float32)),
                         done=jnp.asarray(rng.uniform(size=(T, E, 1)) < 0.2), last_obs=last_obs)
    key = jax.random.PRNGKey(7)
    new_jts, jm = jax.device_get(jax.jit(jpol.train_op)(jts, batch, key))
    perms = np.asarray(jax.random.permutation(jax.random.split(key, 1)[0], T * E))[None]
    traj = {k: _t(getattr(batch, k)) for k in ("obs", "action", "logp", "value", "reward", "done")}
    new_ts, tm = tpol.train_op(ts, traj, _t(last_obs), perms=torch.as_tensor(perms))
    assert set(tm) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(float(tm[k]), float(v), rtol=ACT_METRIC_REL, atol=1e-6,
                                   err_msg=k)
    for name in ("actor", "critic"):
        net = getattr(new_ts, name)
        want = _np(torch.cat([l.reshape(-1) for l in bridge.leaves_of(
            net, getattr(new_jts, f"{name}_params"))]))
        err = np.abs(_np(torch.cat(net_flats(net))) - want)
        assert np.mean(err > 1e-5 * np.abs(want).max()) <= FLIP_SHARE * 10, name
        assert err.max() <= 2 * LR * 2, (name, err.max())
    _close(new_ts.log_std, bridge.actor_log_std(new_jts.actor_params), "log_std")


@pytest.mark.parametrize("kind", ["conv", "mobilenet_v3_small"])
def test_train_runs_ppo_vision(tmp_path, kind):
    m = harness.train(["task=Hover", "env.num_envs=8", "env.max_episode_length=16",
                       "env.obs_depth=true", "env.depth_width=16", "env.depth_height=12",
                       "algo=ppo_vision", f"algo.vision_encoder={kind}", "algo.train_every=8",
                       "algo.num_minibatches=2", "log_interval=1", "save_interval=-1",
                       f"run_dir={tmp_path}", "run_name=v",
                       f"max_iters={2 if kind == 'conv' else 1}"], device="cpu")
    assert all(math.isfinite(v) for k, v in m.items() if not k.startswith("stats/"))
    assert math.isfinite(m["policy_loss"]) and math.isfinite(m["value_loss"])
