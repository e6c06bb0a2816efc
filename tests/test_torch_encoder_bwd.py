"""The encoder backward of the port against the JAX package.

`reference_backward` (the kernel's plain version) is held against the JAX
package's `_bwd_kernel` and `_pair_bwd_kernel` themselves, run in Pallas
interpret mode as tests/test_fused_encoder.py runs them, at S = 80 rows with
tile 32 (a zero-padded tail).  Both sides round at `_backward_core`'s points
and sum in f32 in another order, so they part where a value lies next to a
bf16 rounding boundary, and over 80 rows a single flip still shows in a
leaf's mean: per gradient leaf, the largest error is held to 1e-2 of that
leaf's largest magnitude and the mean error to 2e-3 of its mean magnitude
(measured up to 1.7e-3 and 8.9e-4); the key-bias gradient, analytically
zero, to 1e-5 of the network's largest gradient (measured 1.9e-7).

The port's autograd through `encoder_pair_forward` (CPU: `reference_backward`)
is held against `jax.grad` through `fused_pair_encoder_head`, which off-TPU
is autodiff of `reference_apply`, with other rounding points: as
tests/test_fused_encoder.py does, within 0.03 of each leaf's scale + 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.learning.mappo import Actor, Critic
from mupe_tpu.ops.fused_encoder import EncoderSpec as JSpec
from mupe_tpu.ops.fused_encoder import (
    _build_calls,
    _build_pair_calls,
    extract_leaves,
    fused_pair_encoder_head,
    pack_obs,
)
from mupe_tpu_torch.ops import fused_encoder as fe
from mupe_tpu_torch.ops.tolerance import GradTol, in_f64

torch.set_num_threads(1)
NAMES = ["state_self", "cylinders", "state_others"]
GROUPS = ((1, 35), (3, 5), (2, 3))
WIDE_GROUPS = ((1, 50), (4, 5), (3, 3))  # 8 tokens, state_self 50 wide
TOK16_GROUPS = ((1, 83), (10, 5), (5, 3))  # 16 tokens, 148 columns
S, TILE = 80, 32
PARITY_TOL = GradTol(max_rel=1e-2, mean_rel=2e-3, noise_floor=1e-5, noise_leaves=(-15,))


def _make_case(groups=GROUPS):
    ks = jax.random.split(jax.random.PRNGKey(0), 6)
    obs = {name: jax.random.normal(k, (S,) + kd) for name, k, kd in zip(NAMES, ks, groups)}
    kw = dict(hidden_units=(256,), attn_encoder="PartialAttentionEncoder", obs_is_dict=True,
              dtype=jnp.bfloat16)
    pa = Actor(action_dim=4, **kw).init(ks[3], obs)
    pc = Critic(out_dim=1, **kw).init(ks[4], obs)
    ja = JSpec(groups=groups, head_dim=4, tile=TILE, tile_fwd=TILE)
    jc = JSpec(groups=groups, head_dim=1, tile=TILE, tile_fwd=TILE)
    la = extract_leaves(ja, pa, NAMES)
    lc = extract_leaves(jc, pc, NAMES)
    x, _ = pack_obs(ja, obs, NAMES)
    rng = np.random.default_rng(7)
    da = rng.normal(size=(S, 4)).astype(np.float32)
    dc = rng.normal(size=(S, 1)).astype(np.float32)
    t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32))
    return dict(ja=ja, jc=jc, la=la, lc=lc, x=x, da=da, dc=dc,
                ta=fe.EncoderSpec(groups=groups, head_dim=4),
                tc=fe.EncoderSpec(groups=groups, head_dim=1),
                tla=[t(l) for l in la], tlc=[t(l) for l in lc], tx=t(x))


@pytest.fixture(scope="module")
def case():
    return _make_case()


@pytest.fixture(scope="module")
def wide_case():
    return _make_case(WIDE_GROUPS)


@pytest.fixture(scope="module")
def tok16_case():
    return _make_case(TOK16_GROUPS)


def _pad(a, rows):
    return jnp.concatenate([jnp.asarray(a), jnp.zeros((rows - a.shape[0],) + a.shape[1:])], 0)


def _hold(t_grads, j_grads, tol):
    errs = tol.errors([g.float() for g in t_grads],
                      [torch.as_tensor(np.array(g)).reshape(tuple(t.shape))
                       for g, t in zip(j_grads, t_grads)])
    assert tol.holds(errs), [(i, errs[i]) for i in tol.failing(errs)]


@pytest.mark.parametrize("net", ["actor", "critic", "actor_8_tokens_wide", "actor_16_tokens"])
def test_reference_backward_matches_jax_bwd_kernel(request, net):
    """Per network; the actor also on 8 tokens with a 50-wide group (the
    backward kernel's 8-row tile on the card) and on 16 tokens over 148
    columns (its 16-token instance)."""
    case = request.getfixturevalue({"wide": "wide_case", "tokens": "tok16_case"}.get(
        net.split("_")[-1], "case"))
    spec, jspec, leaves, tleaves, d = (
        (case["ta"], case["ja"], case["la"], case["tla"], case["da"]) if net.startswith("actor")
        else (case["tc"], case["jc"], case["lc"], case["tlc"], case["dc"]))
    rows = -(-S // TILE) * TILE
    _, bwd = _build_calls(jspec, rows, True)
    jg = bwd(_pad(case["x"], rows), _pad(d, rows), *leaves)
    tg = fe.reference_backward(spec, tleaves, case["tx"], torch.as_tensor(d))
    _hold(tg, jg, PARITY_TOL)


def test_pair_backward_matches_jax_pair_bwd_kernel(case):
    rows = -(-S // TILE) * TILE
    _, bwd = _build_pair_calls(case["ja"], case["jc"], rows, True)
    jg = bwd(_pad(case["x"], rows), _pad(case["da"], rows), _pad(case["dc"], rows),
             tuple(case["la"]), tuple(case["lc"]))
    ga, gc = fe.encoder_backward([(case["ta"], case["tla"]), (case["tc"], case["tlc"])],
                                 case["tx"], [torch.as_tensor(case["da"]),
                                              torch.as_tensor(case["dc"])])
    na = len(case["la"])
    _hold(ga, jg[:na], PARITY_TOL)
    _hold(gc, jg[na:], PARITY_TOL)


def test_autograd_through_the_pair_forward_matches_jax_grad(case):
    def jloss(la, lc):
        a, c = fused_pair_encoder_head(case["ja"], case["jc"], la, lc, case["x"])
        return jnp.sum(a * case["da"]) + jnp.sum(c * case["dc"])

    jga, jgc = jax.grad(jloss, argnums=(0, 1))(tuple(case["la"]), tuple(case["lc"]))
    la = [l.clone().requires_grad_() for l in case["tla"]]
    lc = [l.clone().requires_grad_() for l in case["tlc"]]
    a, c = fe.encoder_pair_forward(case["ta"], case["tc"], la, lc, case["tx"])
    loss = (a * torch.as_tensor(case["da"])).sum() + (c * torch.as_tensor(case["dc"])).sum()
    tg = torch.autograd.grad(loss, la + lc)
    for t, j in zip(tg, tuple(jga) + tuple(jgc)):
        j = np.asarray(j).reshape(tuple(t.shape))
        scale = float(np.abs(j).max())
        assert float(np.abs(t.numpy() - j).max()) < 0.03 * scale + 1e-4


@pytest.mark.parametrize("s", [1, 7, 8, 49])
def test_head_bias_gradient_counts_every_row(s):
    """With dout = 1 the head-bias gradient is exactly S (ROADMAP §C: a
    tiled backward must not drop the rows of a ragged last tile)."""
    g = torch.Generator().manual_seed(s)
    spec = fe.EncoderSpec(groups=GROUPS, head_dim=1)
    leaves = [torch.randn(sh, generator=g) * 0.1 for sh in fe.leaf_shapes(spec)]
    x = torch.randn((s, spec.obs_dim), generator=g)
    (grads,) = fe.encoder_backward([(spec, leaves)], x, [torch.ones((s, 1))])
    assert grads[-1].item() == float(s)


@pytest.mark.parametrize("head_dim", [4, 1])
def test_backward_tolerance_rejects_the_f32_control(head_dim):
    """`BWD_KERNEL_TOL` (the kernel's limit) must reject the plain backward
    without its bf16 rounding at S = 300 on every leaf but those of
    `BWD_CONTROL_BLIND`, and accept the plain backward with its sums in
    another order: both against the limits the card applies (the mean limit
    at least `FLOOR_MULT` times the f32 plain version's error against the
    f64 one)."""
    g = torch.Generator().manual_seed(300)
    spec = fe.EncoderSpec(groups=GROUPS, head_dim=head_dim)
    leaves = [torch.randn(sh, generator=g) / (sh[0] ** 0.5) if len(sh) == 2
              else 0.1 * torch.randn(sh, generator=g) for sh in fe.leaf_shapes(spec)]
    x = 2.0 * torch.randn((300, spec.obs_dim), generator=g)
    d = torch.randn((300, head_dim), generator=g)
    ref = fe.reference_backward(spec, leaves, x, d)
    exact = in_f64(fe.reference_backward, spec, leaves, x, d)
    tol = fe.BWD_KERNEL_TOL
    bad = tol.failing(tol.errors(fe.reference_backward(spec, leaves, x, d, bf16=False), ref,
                                 exact))
    blind = {i % len(ref) for i in fe.BWD_CONTROL_BLIND}
    assert set(bad) >= set(range(len(ref))) - blind, bad
    split = [u + v for u, v in zip(fe.reference_backward(spec, leaves, x[:100], d[:100]),
                                   fe.reference_backward(spec, leaves, x[100:], d[100:]))]
    assert tol.holds(tol.errors(split, ref, exact))
