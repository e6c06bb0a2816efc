"""The port's smaller learning modules against the JAX package on the CPU:
the four other action distributions (`TanhGaussian`, `Beta`,
`MultiCategorical`, `TwoHot`), learnable Fourier features (`LFF`), the
trajectory ring buffer (`TrajRingBuffer`: tests/test_learning.py's cases,
and `sample` against JAX's with its env and start draws recomputed from its
key and injected, across the ring's seam) and the observation adapters of
`transforms/obs.py`.

Tolerances: float32 values and gradients within 1e-5 of each tensor's
largest magnitude (JAX's side jitted; the two sum in other orders); the
ring buffer, the discrete-action decoders and `ravel_composite` (against
JAX's eager call, which keeps the dict's order) exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.learning import mybuffer as jbuf
from mupe_tpu.learning.modules import distributions as jd
from mupe_tpu.learning.modules.networks import LFF as JLFF
from mupe_tpu.transforms import obs as jobs
from mupe_tpu_torch import bridge
from mupe_tpu_torch.learning import mybuffer as tbuf
from mupe_tpu_torch.learning.modules import distributions as td
from mupe_tpu_torch.learning.modules.networks import LFF, LeafNet
from mupe_tpu_torch.transforms import obs as tobs

torch.set_num_threads(1)
F32_REL = 1e-5


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                                          np.float32), want, rtol=0,
                               atol=F32_REL * max(np.abs(want).max(), 1e-30), err_msg=what)


def _params_and_grads(jfn, tfn, arrays):
    """JAX's jitted value and gradient of sum(jfn(*arrays)) against the
    port's autograd of tfn on the same float32 arrays."""
    jval = jax.jit(jfn)(*arrays)
    jgrad = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a)), argnums=tuple(range(len(arrays)))))(
        *arrays)
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tval = tfn(*ts)
    tgrad = torch.autograd.grad(torch.sum(tval), ts)
    return jval, jgrad, tval, tgrad


def _hold(jfn, tfn, arrays, what):
    jval, jgrad, tval, tgrad = _params_and_grads(jfn, tfn, arrays)
    _close(tval, jval, f"{what} value")
    for i, (t, j) in enumerate(zip(tgrad, jgrad)):
        _close(t, j, f"{what} gradient {i}")


# ------------------------------------------------------------------ distributions
def test_tanh_gaussian_matches_jax():
    rng = np.random.default_rng(0)
    mean = rng.normal(size=(6, 4)).astype(np.float32)
    log_std = rng.normal(scale=0.3, size=(6, 4)).astype(np.float32)
    # values inside (-1, 1) and at the clipped ends
    value = np.tanh(rng.normal(size=(6, 4))).astype(np.float32)
    value[0, :2] = [1.0, -1.0]
    jval, jgrad, tval, tgrad = _params_and_grads(
        lambda m, s, v: jd.TanhGaussian(m, s).log_prob(v),
        lambda m, s, v: td.TanhGaussian(m, s).log_prob(v), (mean, log_std, value))
    _close(tval[1:], np.asarray(jval)[1:], "log_prob inside (-1, 1)")
    for i, (t, j) in enumerate(zip(tgrad, jgrad)):
        _close(t, j, f"log_prob gradient {i}")
    # at the clip ends 1 - tanh(atanh(1 - 1e-6))^2 + 1e-6 is ~3e-6 and its
    # tanh one float32 step from 1, so the libraries' tanh may part the
    # correction's log by 2 steps of tanh over it, per clipped dimension
    t = np.tanh(np.arctanh(np.float32(1.0 - 1e-6)), dtype=np.float32)
    bound = 2 * 2 * 2 * np.finfo(np.float32).eps / (1.0 - float(t) ** 2 + 1e-6)
    assert abs(float(tval[0]) - float(jval[0])) <= bound, (float(tval[0]), float(jval[0]), bound)
    _close(td.TanhGaussian(torch.tensor(mean), torch.tensor(log_std)).mode,
           jd.TanhGaussian(mean, log_std).mode, "mode")
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, mean.shape))
    _close(td.TanhGaussian(torch.tensor(mean), torch.tensor(log_std)).sample(
        noise=torch.tensor(noise)), jax.jit(lambda m, s: jd.TanhGaussian(m, s).sample(key))(
        mean, log_std), "sample")


def test_beta_matches_jax():
    rng = np.random.default_rng(1)
    alpha = rng.uniform(1.2, 4.0, size=(5, 3)).astype(np.float32)
    beta = rng.uniform(1.2, 4.0, size=(5, 3)).astype(np.float32)
    low, high = -2.0, 3.0
    value = rng.uniform(low, high, size=(5, 3)).astype(np.float32)
    value[0, 0], value[0, 1] = low, high  # clipped 1e-6 inside
    _hold(lambda a, b, v: jd.Beta(a, b, low, high).log_prob(v),
          lambda a, b, v: td.Beta(a, b, low, high).log_prob(v), (alpha, beta, value), "log_prob")
    _close(td.Beta(torch.tensor(alpha), torch.tensor(beta), low, high).mode,
           jd.Beta(alpha, beta, low, high).mode, "mode")
    key = jax.random.PRNGKey(4)
    unit = np.asarray(jax.random.beta(key, alpha, beta))
    _close(td.Beta(torch.tensor(alpha), torch.tensor(beta), low, high).sample(torch.tensor(unit)),
           jax.jit(lambda a, b: jd.Beta(a, b, low, high).sample(key))(alpha, beta), "sample")


def test_multi_categorical_matches_jax():
    rng = np.random.default_rng(2)
    logits = [rng.normal(size=(7, n)).astype(np.float32) for n in (3, 5, 2)]
    value = np.stack([rng.integers(0, l.shape[-1], size=7) for l in logits], axis=-1)
    jval = jnp.asarray(value)
    _hold(lambda *l: jd.MultiCategorical(l).log_prob(jval),
          lambda *l: td.MultiCategorical(l).log_prob(torch.as_tensor(value)), logits, "log_prob")
    _hold(lambda *l: jd.MultiCategorical(l).entropy(),
          lambda *l: td.MultiCategorical(l).entropy(), logits, "entropy")
    tl = tuple(torch.tensor(l) for l in logits)
    np.testing.assert_array_equal(td.MultiCategorical(tl).mode.numpy(),
                                  np.asarray(jd.MultiCategorical(logits).mode))
    draw = td.MultiCategorical(tl).sample(torch.Generator().manual_seed(0))
    assert draw.shape == (7, 3) and all(
        bool((draw[:, i] >= 0).all() and (draw[:, i] < l.shape[-1]).all())
        for i, l in enumerate(logits))


def test_two_hot_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(9, 11)).astype(np.float32)
    # inside bins, exactly on bin edges (searchsorted side="right"), past
    # both ends (clipped), and the top edge (index clipped to n - 2)
    value = np.array([[-7.3], [0.0], [4.0], [-20.0], [20.0], [25.0], [-31.0], [12.5], [-4.0]],
                     np.float32)
    jval, jgrad, tval, tgrad = _params_and_grads(
        lambda l, v: jd.TwoHot(l).log_prob(v), lambda l, v: td.TwoHot(l).log_prob(v),
        (logits, value))
    _close(tval, jval, "log_prob")
    _close(tgrad[0], jgrad[0], "log_prob gradient (logits)")
    # d/dvalue at the clip bounds is a subgradient at a kink (jnp.clip gives
    # a tie half, torch.clamp all of it): held off the bounds only
    inside = np.abs(value[:, 0]) < 20.0
    _close(tgrad[1][inside], np.asarray(jgrad[1])[inside], "log_prob gradient (value)")
    np.testing.assert_array_equal(td.TwoHot(torch.tensor(logits)).support.numpy(),
                                  np.asarray(jd.TwoHot(logits).support))
    _hold(lambda l: jd.TwoHot(l).mean, lambda l: td.TwoHot(l).mean, (logits,), "mean")
    _close(td.TwoHot(torch.tensor(logits)).mode, jd.TwoHot(logits).mode, "mode")


# ------------------------------------------------------------------ LFF
class _LFFNet(LeafNet):
    def __init__(self, d_in, cat_input, leaves=None):
        super().__init__()
        self.lff, self.d_in = LFF("LFF_0", fourier_dim=16, embed_dim=8,
                                  cat_input=cat_input), d_in
        self._make_flat(leaves, torch.Generator().manual_seed(0))

    def leaf_specs(self):
        return self.lff.leaf_specs(self.d_in)

    def forward(self, x):
        return self.lff(self.params(), x)


@pytest.mark.parametrize("cat_input", [True, False])
def test_lff_matches_flax(cat_input):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, 3, 6)).astype(np.float32)
    jm = JLFF(fourier_dim=16, embed_dim=8, sigma=0.3, cat_input=cat_input)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), x)
    wrapped = {"params": {"LFF_0": params["params"]}}
    net = _LFFNet(6, cat_input)
    net = _LFFNet(6, cat_input, leaves=bridge.named_leaves(wrapped, net))
    cot = rng.normal(size=(5, 3, 8)).astype(np.float32)
    jout = jax.jit(jm.apply)(params, x)
    jg_p, jg_x = jax.jit(jax.grad(lambda p, x_: jnp.sum(jm.apply(p, x_) * cot),
                                  argnums=(0, 1)))(params, x)
    xt = torch.tensor(x, requires_grad=True)
    out = net(xt)
    gp, gx = torch.autograd.grad(torch.sum(out * torch.tensor(cot)), [net.flat, xt])
    _close(out, jout, "output")
    _close(gx, jg_x, "input gradient")
    want = bridge.named_leaves({"params": {"LFF_0": jg_p["params"]}}, net)
    for got, w, leaf in zip(torch.split(gp, [int(np.prod(s)) for s in net.leaf_shapes()]), want,
                            net.leaf_specs()):
        _close(got.reshape(leaf.shape), w.numpy(), leaf.path)
    # the B initialiser: sigma times a standard normal
    b = _LFFNet(400, cat_input).params()["LFF_0/B"]
    assert abs(float(b.std()) - 0.01) < 1e-3


# ------------------------------------------------------------------ ring buffer
def _chunk(t0, t, e):
    steps = torch.arange(t0, t0 + t, dtype=torch.float32)
    return {"obs": steps[:, None, None].expand(t, e, 3).clone(),
            "r": steps[:, None, None].expand(t, e, 1).clone()}


def test_ring_buffer_extend_wrap_and_sample():
    """tests/test_learning.py's cases on the port's buffer."""
    e = 4
    example = {"obs": torch.zeros((e, 3)), "r": torch.zeros((e, 1))}
    buf = tbuf.TrajRingBuffer.create(example, capacity=10)
    assert int(tbuf.size(buf)) == 0
    buf = tbuf.extend(buf, _chunk(0, 4, e))
    buf = tbuf.extend(buf, _chunk(4, 4, e))
    assert int(tbuf.size(buf)) == 8 and int(buf.cursor) == 8
    buf = tbuf.extend(buf, _chunk(8, 4, e))           # wraps: rows 8, 9, 0, 1
    assert int(tbuf.size(buf)) == 10 and int(buf.cursor) == 2
    assert float(buf.storage["obs"][0, 0, 0]) == 10.0 and float(buf.storage["obs"][9, 0, 0]) == 9.0
    gen = torch.Generator().manual_seed(0)
    batch, ok = tbuf.sample(buf, 16, 5, generator=gen)
    assert ok.shape == (16,) and bool(ok.all()) and batch["obs"].shape == (16, 5, 3)
    o = batch["obs"][:, :, 0].numpy()
    for row in o:  # chronological windows of the steps 2..11 the buffer holds
        np.testing.assert_array_equal(np.diff(row), 1.0)
        assert 2.0 <= row[0] and row[-1] <= 11.0, row
    short = tbuf.extend(tbuf.TrajRingBuffer.create(example, capacity=10), _chunk(0, 3, e))
    _, ok2 = tbuf.sample(short, 4, 5, generator=gen)
    assert ok2.shape == (4,) and not bool(ok2.any())
    batch3, ok3 = tbuf.sample(short, 4, 2, generator=gen)
    assert bool(ok3.all())
    for row in batch3["obs"][:, :, 0].numpy():
        np.testing.assert_array_equal(np.diff(row), 1.0)
        assert 0.0 <= row[0] and row[-1] <= 2.0


@pytest.mark.parametrize("extends", [(4, 4, 4), (3,), (6, 7, 9)], ids=["seam", "short", "twice"])
def test_ring_buffer_sample_matches_jax(extends):
    """The same extends and JAX's draws give the same windows, bit for
    bit, whether the buffer wrapped its seam once, not at all or twice."""
    e, cap, batch_size, seq_len = 5, 12, 24, 4
    rng = np.random.default_rng(5)
    jb = jbuf.TrajRingBuffer.create({"x": jnp.zeros((e, 2)), "y": jnp.zeros((e,), jnp.int32)}, cap)
    tb = tbuf.TrajRingBuffer.create({"x": torch.zeros((e, 2)), "y": torch.zeros((e,),
                                                                             dtype=torch.int32)},
                                    cap)
    for t in extends:
        data = {"x": rng.normal(size=(t, e, 2)).astype(np.float32),
                "y": rng.integers(0, 100, size=(t, e)).astype(np.int32)}
        jb = jax.jit(jbuf.extend)(jb, data)
        tb = tbuf.extend(tb, {k: torch.as_tensor(v) for k, v in data.items()})
    assert int(tb.cursor) == int(jb.cursor) and int(tb.length) == int(jb.length)
    for k in ("x", "y"):
        np.testing.assert_array_equal(tb.storage[k].numpy(), np.asarray(jb.storage[k]))
    key = jax.random.PRNGKey(9)
    jbatch, jvalid = jax.jit(jbuf.sample, static_argnums=(2, 3))(jb, key, batch_size, seq_len)
    k_env, k_t = jax.random.split(key)
    env_idx = jax.random.randint(k_env, (batch_size,), 0, e)
    t0 = jax.random.randint(k_t, (batch_size,), 0, max(int(jb.length) - seq_len, 1))
    tbatch, tvalid = tbuf.sample(tb, batch_size, seq_len, env_idx=torch.as_tensor(
        np.array(env_idx)).long(), t0=torch.as_tensor(np.array(t0)).long())
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    for k in ("x", "y"):
        np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(jbatch[k]))


# ------------------------------------------------------------------ transforms/obs.py
def test_observation_adapters_match_jax():
    rng = np.random.default_rng(6)
    obs = {"state_self": rng.normal(size=(4, 3, 1, 7)).astype(np.float32),
           "cylinders": rng.normal(size=(4, 3, 5, 5)).astype(np.float32)}
    # in the dict's order, as JAX's eager call (jit would hand it sorted keys)
    np.testing.assert_array_equal(
        tobs.ravel_composite({k: torch.as_tensor(v) for k, v in obs.items()}).numpy(),
        np.asarray(jobs.ravel_composite(obs)))
    idx = np.arange(0, 5 ** 3).astype(np.int32)
    np.testing.assert_array_equal(
        tobs.from_discrete_action(torch.as_tensor(idx), 5, 3).numpy(),
        np.asarray(jax.jit(jobs.from_discrete_action, static_argnums=(1, 2))(idx, 5, 3)))
    midx = rng.integers(0, 4, size=(6, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tobs.from_multidiscrete_action(torch.as_tensor(midx), (4, 5, 7)).numpy(),
        np.asarray(jax.jit(lambda a: jobs.from_multidiscrete_action(a, (4, 5, 7)))(midx)))
    depth = rng.uniform(-1.0, 12.0, size=(3, 12, 16)).astype(np.float32)
    _close(tobs.depth_image_norm(torch.as_tensor(depth), 0.02, 8.0),
           jax.jit(lambda d: jobs.depth_image_norm(d, 0.02, 8.0))(depth), "depth_image_norm")
