"""The encoder backward's two plain stages against the JAX package, and the
weight-gradient stage's split of the rows.

`reference_backward_operands` (stage A: the recomputed forward, the chain of
data gradients, the staged bf16 operands of the `_mm_tn` products and the
column sums) followed by `reference_weight_grads` (stage B: those products)
is held against the JAX package's `_bwd_kernel`, `_pair_bwd_kernel` and
`_pair_fwd_loss_agrad_kernel` themselves, in Pallas interpret mode with tile
32, at S = 1, 7, 17 and 80 rows: none a multiple of the tile or of the
stage-B step (32 rows), so every case has zero-padded rows on the JAX side.
Both sides round at `_backward_core`'s points and sum in f32 in another
order, so they part where a value lies next to a bf16 rounding boundary: per
gradient leaf the largest error is held to 1e-2 of that leaf's largest
magnitude and the mean error to 2e-3 of its mean magnitude from 80 rows on,
5e-3 below (a single flip moves a leaf's mean over a handful of rows;
BWD_KERNEL_TOL's rule on the card); the key-bias gradient, analytically zero,
to 1e-5 of the network's largest gradient.  The split-K plan is checked by
property: every staged row in exactly one chunk, in order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import mupe_tpu.ops.fused_encoder as jfe
from mupe_tpu.learning.mappo import Actor, Critic
from mupe_tpu_torch.ops import fused_encoder as fe
from mupe_tpu_torch.ops.tolerance import GradTol

torch.set_num_threads(1)
NAMES = ["state_self", "cylinders", "state_others"]
GROUPS = ((1, 35), (3, 5), (2, 3))
WIDE_GROUPS = ((1, 50), (4, 5), (3, 3))  # 8 tokens, state_self 50 wide
TOK16_GROUPS = ((1, 83), (10, 5), (5, 3))  # 16 tokens, 148 columns
TILE = 32
A = 4
SIZES = [1, 7, 17, 80]


def _tol(s):
    return GradTol(max_rel=1e-2, mean_rel=2e-3 if s >= 80 else 5e-3, noise_floor=1e-5,
                   noise_leaves=(-15,))


def _make_nets(groups):
    ks = jax.random.split(jax.random.PRNGKey(0), 6)
    obs = {name: jnp.zeros((1,) + kd) for name, kd in zip(NAMES, groups)}
    kw = dict(hidden_units=(256,), attn_encoder="PartialAttentionEncoder", obs_is_dict=True,
              dtype=jnp.bfloat16)
    pa = Actor(action_dim=A, **kw).init(ks[3], obs)
    pc = Critic(out_dim=1, **kw).init(ks[4], obs)
    ja = jfe.EncoderSpec(groups=groups, head_dim=A, tile=TILE, tile_fwd=TILE)
    jc = jfe.EncoderSpec(groups=groups, head_dim=1, tile=TILE, tile_fwd=TILE)
    la = jfe.extract_leaves(ja, pa, NAMES)
    lc = jfe.extract_leaves(jc, pc, NAMES)
    t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32))
    return dict(ja=ja, jc=jc, la=la, lc=lc, tla=[t(l) for l in la], tlc=[t(l) for l in lc],
                ta=fe.EncoderSpec(groups=groups, head_dim=A),
                tc=fe.EncoderSpec(groups=groups, head_dim=1))


@pytest.fixture(scope="module")
def nets():
    return _make_nets(GROUPS)


@pytest.fixture(scope="module")
def wide_nets():
    return _make_nets(WIDE_GROUPS)


@pytest.fixture(scope="module")
def tok16_nets():
    return _make_nets(TOK16_GROUPS)


def _pad(a, rows):
    a = np.asarray(a, dtype=np.float32)
    return jnp.asarray(np.concatenate([a, np.zeros((rows - a.shape[0],) + a.shape[1:],
                                                   np.float32)]))


def _two_stages(spec, leaves, x, d):
    staged, sums = fe.reference_backward_operands(spec, leaves, torch.as_tensor(x),
                                                  torch.as_tensor(d))
    return fe._canonical(spec, sums, fe.reference_weight_grads(spec, staged))


def _hold(t_grads, j_grads, tol):
    errs = tol.errors([g.float() for g in t_grads],
                      [torch.as_tensor(np.array(g)).reshape(tuple(t.shape))
                       for g, t in zip(j_grads, t_grads)])
    assert tol.holds(errs), [(i, errs[i]) for i in tol.failing(errs)]


def _rows(s, seed, groups=GROUPS):
    rng = np.random.default_rng(seed)
    return (2.0 * rng.normal(size=(s, sum(k * d for k, d in groups)))).astype(np.float32), rng


@pytest.mark.parametrize("net", ["actor", "critic", "actor_8_tokens_wide", "actor_16_tokens"])
@pytest.mark.parametrize("s", SIZES)
def test_two_stages_match_jax_bwd_kernel(request, s, net):
    """Per network; the actor also on 8 tokens with a 50-wide group and on
    16 tokens over 148 columns."""
    kind = {"wide": "wide", "tokens": "tok16"}.get(net.split("_")[-1], "main")
    nets = request.getfixturevalue({"wide": "wide_nets", "tok16": "tok16_nets"}.get(kind, "nets"))
    x, rng = _rows(s, s, {"wide": WIDE_GROUPS, "tok16": TOK16_GROUPS}.get(kind, GROUPS))
    hd = A if net.startswith("actor") else 1
    d = rng.normal(size=(s, hd)).astype(np.float32)
    jspec, leaves, tspec, tleaves = ((nets["ja"], nets["la"], nets["ta"], nets["tla"])
                                     if net.startswith("actor") else
                                     (nets["jc"], nets["lc"], nets["tc"], nets["tlc"]))
    rows = -(-s // TILE) * TILE
    _, bwd = jfe._build_calls(jspec, rows, True)
    jg = bwd(_pad(x, rows), _pad(d, rows), *leaves)
    tg = _two_stages(tspec, tleaves, x, d)
    _hold(tg, jg, _tol(s))
    assert all(torch.equal(u, v) for u, v in
               zip(tg, fe.reference_backward(tspec, tleaves, torch.as_tensor(x),
                                             torch.as_tensor(d))))


@pytest.mark.parametrize("s", SIZES)
def test_two_stages_match_jax_pair_bwd_kernel(nets, s):
    x, rng = _rows(s, s + 100)
    da = rng.normal(size=(s, A)).astype(np.float32)
    dc = rng.normal(size=(s, 1)).astype(np.float32)
    rows = -(-s // TILE) * TILE
    _, bwd = jfe._build_pair_calls(nets["ja"], nets["jc"], rows, True)
    jg = bwd(_pad(x, rows), _pad(da, rows), _pad(dc, rows), tuple(nets["la"]), tuple(nets["lc"]))
    na = len(nets["la"])
    _hold(_two_stages(nets["ta"], nets["tla"], x, da), jg[:na], _tol(s))
    _hold(_two_stages(nets["tc"], nets["tlc"], x, dc), jg[na:], _tol(s))


@pytest.mark.parametrize("s", SIZES)
def test_agrad_two_stages_match_jax_kernel(nets, s):
    """`reference_agrad_operands` then `reference_weight_grads` against
    `_pair_fwd_loss_agrad_kernel`: the actor's gradients per leaf; dv1, dv2
    and stats are `reference_pair_fwd_loss`'s bits (held against the JAX
    kernels in tests/test_torch_inkernel_loss.py)."""
    x, rng = _rows(s, s + 200)
    cfg = jfe.PPOLossCfg(0.2, 10.0, A, s)
    tloss = fe.PPOLossCfg(0.2, 10.0, A, s)
    log_std = np.asarray([0.1, -0.2, 0.3, -0.4], np.float32)
    ins = [(0.5 * rng.normal(size=(s, A))).astype(np.float32),
           rng.normal(-5.5, 0.2, (s, 1)).astype(np.float32),
           rng.normal(0.0, 1.0, (s, 1)).astype(np.float32),
           rng.normal(0.0, 0.3, (s, 1)).astype(np.float32),
           rng.normal(0.0, 0.3, (s, 1)).astype(np.float32)]
    rows = -(-s // TILE) * TILE
    call = jfe._build_pair_loss_agrad_call(nets["ja"], nets["jc"], cfg, rows, True)
    *_, jga = call(_pad(x, rows), *(_pad(a, rows) for a in ins),
                                   jnp.asarray(log_std), tuple(nets["la"]), tuple(nets["lc"]))
    targs = (nets["ta"], nets["tc"], tloss, nets["tla"], nets["tlc"], torch.as_tensor(log_std),
             torch.as_tensor(x), *map(torch.as_tensor, ins))
    dv1, dv2, stats, staged, sums = fe.reference_agrad_operands(*targs)
    fwd = fe.reference_pair_fwd_loss(*targs)
    assert all(torch.equal(u, v) for u, v in zip((dv1, dv2, stats), fwd[1:]))
    ga = fe._canonical(nets["ta"], sums, fe.reference_weight_grads(nets["ta"], staged))
    _hold(ga, jga, _tol(s))
    assert all(torch.equal(u, v) for u, v in zip(ga, fe.reference_pair_fwd_loss_agrad(*targs)[3]))


def test_staged_operands_are_bf16_values_and_weight_leaves_are_the_products():
    """Stage A's staging holds bf16 values (each staged operand is already
    rounded), and stage B fills exactly `weight_leaves`."""
    g = torch.Generator().manual_seed(5)
    spec = fe.EncoderSpec(groups=GROUPS, head_dim=A)
    leaves = [torch.randn(sh, generator=g) * 0.1 for sh in fe.leaf_shapes(spec)]
    x = torch.randn((9, spec.obs_dim), generator=g)
    staged, sums = fe.reference_backward_operands(spec, leaves, x, torch.randn((9, A),
                                                                               generator=g))
    for k, v in staged.items():
        for t in (v if k == "xs" else (v,)):
            assert torch.equal(t, t.to(torch.bfloat16).float()), k
    weights = set(fe.reference_weight_grads(spec, staged))
    assert weights == set(fe.weight_leaves(spec)) and not weights & set(sums)
    assert weights | set(sums) == set(range(spec.n_leaves))


@settings(max_examples=200, deadline=None)
@given(k_rows=st.integers(0, 40_000).map(lambda n: n * fe.STAGE_ROWS),
       blocks=st.integers(1, 5_000))
def test_split_k_covers_every_staged_row_once_in_order(k_rows, blocks):
    bounds = fe.split_k(k_rows, blocks, fe.STAGE_ROWS)
    assert len(bounds) <= blocks
    covered = [r for lo, hi in bounds for r in range(lo, hi)] if k_rows <= 20_000 else None
    if covered is not None:
        assert covered == list(range(k_rows))
    assert [lo for lo, _ in bounds] == sorted(lo for lo, _ in bounds)
    assert all(b[1] == c[0] for b, c in zip(bounds, bounds[1:]))
    assert (bounds[0][0] if bounds else 0) == 0 and (bounds[-1][1] if bounds else 0) == k_rows
    assert all(hi > lo and (hi - lo) % fe.STAGE_ROWS == 0 for lo, hi in bounds)
    if bounds:  # the kernel's own bounds from (k_rows, chunk): the same chunks
        chunk = bounds[0][1] - bounds[0][0]
        assert -(-k_rows // chunk) == len(bounds)
        assert bounds == tuple((c * chunk, min(c * chunk + chunk, k_rows))
                               for c in range(len(bounds)))


@settings(max_examples=100, deadline=None)
@given(s=st.integers(0, 200_000), n_tok=st.integers(1, 6))
def test_stage_b_plan_of_the_backward_covers_its_rows(s, n_tok):
    """The wrapper's plan for a backward of S rows: each product's K (the
    staged rows, or n_tok of them for wk / wv) split into chunks of
    `stage_b_chunk` rows, every staged row (S padded to 32) in one chunk."""
    s_pad = fe.staged_rows(s)
    assert s_pad >= s and s_pad % fe.STAGE_ROWS == 0 and s_pad - s < fe.STAGE_ROWS
    for k_rows in (s_pad, n_tok * s_pad):
        chunk = fe.stage_b_chunk(k_rows)
        assert chunk % fe.STAGE_ROWS == 0 and chunk >= fe.STAGE_ROWS
        n = -(-k_rows // chunk)
        assert n * chunk >= k_rows > (n - 1) * chunk or k_rows == 0
        assert n <= max(1, round(k_rows / fe.STAGE_B_ROWS))
