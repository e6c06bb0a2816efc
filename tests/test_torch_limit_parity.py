"""The port against the JAX package past every limit the kernels' tile
instances had: chip_smoke.py phase 9's configuration (8 pursuers, 20
cylinders all observed, 40 predicted steps, a 40-step history, the obstacles
in the TP input), that is 28 tokens over 261 columns with `state_self` 140
wide, and the TP net at 91 inputs, 40 steps and 120 outputs.

The same numpy-seeded inputs and leaves go through the JAX package's Pallas
kernels in interpret mode (`_build_calls`, `_build_pair_loss_call`,
`_build_tp_calls_t`, as its own tests run them on the CPU) or its
off-TPU reference (`fused_pair_encoder_head`) and through the port's plain
versions, which its kernels are held to on the card.  Both round at the same
points and sum in f32 in another order; the limits are the port's parity
tests' own: the forward to 5e-3 of the output's largest magnitude
(tests/test_torch_encoder.py), each gradient leaf to 1e-2 of its largest
magnitude and 2e-3 (encoder) or 1e-3 (TP) of its mean magnitude
(tests/test_torch_encoder_bwd.py, tests/test_torch_tp_lstm_bwd.py; the
encoder's with its mean and noise limits at least 5x the f32 plain version's
own error against it in f64, as tests/test_torch_inkernel_loss.py holds its
16-token case), the loss kernel's per-row outputs to the small-S per-row
limits `loss_row_tols` (48 rows).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mupe_tpu.learning.mappo import MAPPOCfg as JCfg
from mupe_tpu.ops import fused_encoder as jfe
from mupe_tpu.ops.tp_lstm import TPLSTMSpec as JTPSpec
from mupe_tpu.ops.tp_lstm import _build_tp_calls_t
from mupe_tpu_torch.ops import fused_encoder as fe
from mupe_tpu_torch.ops import tp_lstm as tl
from mupe_tpu_torch.ops.tolerance import GradTol, in_f64

torch.set_num_threads(1)
GROUPS = ((1, 140), (20, 5), (7, 3))  # state_self, cylinders, state_others
TP = (91, 40, 120)
S, TILE = 48, 16
FWD_REL = 5e-3
ENC_PARITY = GradTol(max_rel=1e-2, mean_rel=2e-3, noise_floor=1e-5, noise_leaves=(-15,))
TP_PARITY = GradTol(max_rel=1e-2, mean_rel=1e-3)


def _unit_leaves(rng, spec):
    out = []
    for shape in fe.leaf_shapes(spec):
        if len(shape) == 2:
            out.append((rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32))
        else:
            out.append((1.0 * (len(out) % 2 == 0) + 0.1 * rng.normal(size=shape))
                       .astype(np.float32))
    return out


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(28)
    spec_a = fe.EncoderSpec(groups=GROUPS, head_dim=4)
    spec_c = fe.EncoderSpec(groups=GROUPS, head_dim=1)
    assert spec_a.n_tokens == 28 and spec_a.obs_dim == 261
    assert fe.kernel_spec_ok(spec_a) and not fe.tile_spec_ok(spec_a)
    la, lc = _unit_leaves(rng, spec_a), _unit_leaves(rng, spec_c)
    x = rng.normal(0, 2, (S, spec_a.obs_dim)).astype(np.float32)
    da = rng.normal(size=(S, 4)).astype(np.float32)
    return dict(rng=rng, spec_a=spec_a, spec_c=spec_c, la=la, lc=lc, x=x, da=da,
                ja=jfe.EncoderSpec(groups=GROUPS, head_dim=4, tile=TILE, tile_fwd=TILE),
                jc=jfe.EncoderSpec(groups=GROUPS, head_dim=1, tile=TILE, tile_fwd=TILE))


def _t(arrays):
    return [torch.as_tensor(np.asarray(a, dtype=np.float32)) for a in arrays]


def test_pair_forward_matches_jax_reference_at_28_tokens(case):
    ja, jc = jfe.fused_pair_encoder_head(
        case["ja"], case["jc"], tuple(map(jnp.asarray, case["la"])),
        tuple(map(jnp.asarray, case["lc"])), jnp.asarray(case["x"]))
    ta, tc = fe.encoder_pair_forward(case["spec_a"], case["spec_c"], _t(case["la"]),
                                     _t(case["lc"]), torch.as_tensor(case["x"]))
    for got, want in ((ta, ja), (tc, jc)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0.3  # O(1) outputs
        np.testing.assert_allclose(got.numpy(), want, atol=FWD_REL * np.abs(want).max(), rtol=0)


def test_reference_backward_matches_jax_bwd_kernel_at_28_tokens(case):
    """The actor's backward: the port's plain version (the card's kernels'
    reference) against the JAX package's `_bwd_kernel` in interpret mode."""
    _, bwd = jfe._build_calls(case["ja"], S, True)
    jg = bwd(jnp.asarray(case["x"]), jnp.asarray(case["da"]), *case["la"])
    tg = fe.reference_backward(case["spec_a"], _t(case["la"]), torch.as_tensor(case["x"]),
                               torch.as_tensor(case["da"]))
    want = [torch.as_tensor(np.array(g)).reshape(tuple(t.shape)) for g, t in zip(jg, tg)]
    # as tests/test_torch_inkernel_loss.py holds its 16-token case: with the
    # port's plain version in f64, each mean limit and the key bias's noise
    # limit are at least FLOOR_MULT times the f32 version's error against it
    # (28 tokens add noise to the analytically zero key-bias gradient)
    exact = in_f64(fe.reference_backward, case["spec_a"], _t(case["la"]),
                   torch.as_tensor(case["x"]), torch.as_tensor(case["da"]))
    scale = max(g.abs().max().item() for g in tg)
    noise = max((tg[i] - exact[i]).abs().max().item() / scale for i in ENC_PARITY.noise_leaves)
    tol = dataclasses.replace(ENC_PARITY, floor_mult=fe.FLOOR_MULT,
                              noise_floor=max(ENC_PARITY.noise_floor, fe.FLOOR_MULT * noise))
    errs = tol.errors(want, list(tg), exact)
    assert tol.holds(errs), [(i, errs[i]) for i in tol.failing(errs)]


def test_reference_pair_fwd_loss_matches_jax_kernel_at_28_tokens(case):
    """The forward + loss math (`_pair_fwd_loss_kernel` with `_loss_math`,
    interpret mode) against `reference_pair_fwd_loss`."""
    rng = np.random.default_rng(5)
    cfg = JCfg()
    eps = cfg.clip_param
    log_std = (-1.0 + 0.3 * rng.normal(size=4)).astype(np.float32)
    mean, vout = (np.asarray(m, dtype=np.float64) for m in jfe.fused_pair_encoder_head(
        case["ja"], case["jc"], tuple(map(jnp.asarray, case["la"])),
        tuple(map(jnp.asarray, case["lc"])), jnp.asarray(case["x"])))
    # as chip_smoke.py's `loss_inputs`: ratios 2e-2 or more, value offsets
    # 1e-2 or more from the clip rails, so that no row's branch flips
    act = mean + np.exp(log_std) * rng.normal(size=(S, 4))
    z = (act - mean) / np.exp(log_std)
    logp = np.sum(-0.5 * z * z - log_std - 0.5 * np.log(2 * np.pi), -1, keepdims=True)
    ratio = 0.5 + 1.1 * rng.random((S, 1))
    for rail in (1.0 - eps, 1.0 + eps):
        ratio = np.where(np.abs(ratio - rail) < 2e-2, ratio + 4e-2, ratio)
    off = 0.1 * rng.normal(size=(S, 1))
    off = np.where(np.abs(np.abs(off) - eps) < 1e-2, 1.25 * off, off)
    rows = [a.astype(np.float32) for a in (act, logp - np.log(ratio), rng.normal(size=(S, 1)),
                                           vout - off, vout + 0.3 * rng.normal(size=(S, 1)))]
    jloss = jfe.PPOLossCfg(cfg.clip_param, cfg.huber_delta, 4, S)
    tloss = fe.PPOLossCfg(cfg.clip_param, cfg.huber_delta, 4, S)
    call = jfe._build_pair_loss_call(case["ja"], case["jc"], jloss, S, True)
    jout = call(jnp.asarray(case["x"]), *map(jnp.asarray, rows), jnp.asarray(log_std),
                tuple(case["la"]), tuple(case["lc"]))
    tout = fe.reference_pair_fwd_loss(case["spec_a"], case["spec_c"], tloss, _t(case["la"]),
                                      _t(case["lc"]), torch.as_tensor(log_std),
                                      torch.as_tensor(case["x"]), *_t(rows))

    # below 300 rows the per-row limits of `loss_row_tols` (one row's error
    # is the mean), the stats column by column; with the port's plain version
    # in f64, each limit at least FLOOR_MULT times the f32 version's error
    # against it (a bf16 flip early in one of 28 tokens moves a row's mean,
    # and its log-prob by z / sigma times that)
    args = (case["spec_a"], case["spec_c"], tloss, _t(case["la"]), _t(case["lc"]),
            torch.as_tensor(log_std), torch.as_tensor(case["x"]), *_t(rows))
    exact = in_f64(fe.reference_pair_fwd_loss, *args)
    rows_tol, stats_tol = fe.loss_row_tols(S)
    want = [torch.as_tensor(np.array(w))[:S] for w in jout]
    for w, got, ex in zip(want[:3], tout[:3], exact[:3]):
        errs = rows_tol.errors(w, got, ex)
        assert rows_tol.holds(errs), errs
    for c in range(want[3].shape[1]):
        errs = stats_tol.errors(want[3][:, c], tout[3][:, c], exact[3][:, c])
        assert stats_tol.holds(errs), (c, errs)


def _tp_case(n):
    f, t, o = TP
    rng = np.random.default_rng(91)
    spec = tl.TPLSTMSpec(input_dim=f, hidden=64, t_steps=t, out_dim=o)
    leaves = [(rng.normal(size=s) / np.sqrt(s[0]) if len(s) == 2 else 0.1 * rng.normal(size=s))
              .astype(np.float32) for s in spec.leaf_shapes()]
    x = rng.normal(size=(n, t, f)).astype(np.float32)
    dy = rng.normal(size=(n, o)).astype(np.float32)
    wi, wh, b, wfc, bfc = leaves
    op = -(-o // 8) * 8  # the JAX kernel's output rows, padded to a multiple of 8
    tleaves = (jnp.asarray(wi.T), jnp.asarray(wh.T), jnp.asarray(b[:, None]),
               jnp.asarray(np.concatenate([wfc.T, np.zeros((op - o, 64), np.float32)])),
               jnp.asarray(np.concatenate([bfc[:, None], np.zeros((op - o, 1), np.float32)])))
    xt = jnp.asarray(x.transpose(1, 2, 0).reshape(t * f, n))
    dyt = jnp.asarray(np.concatenate([dy.T, np.zeros((op - o, n), np.float32)]))
    fwd, bwd = _build_tp_calls_t(JTPSpec(input_dim=f, hidden=64, t_steps=t, out_dim=o), n, True)
    return spec, leaves, x, dy, tleaves, xt, dyt, fwd, bwd


def test_tp_forward_and_backward_match_jax_kernels_at_the_limit_shape():
    """F 91, T 40, O 120 over 128 windows (the JAX kernels' lane tile):
    `reference_forward` and `reference_backward` against `_tp_fwd_kernel_t`
    and `_tp_bwd_kernel_t` in interpret mode."""
    n = 128
    f, t, o = TP
    spec, leaves, x, dy, tleaves, xt, dyt, fwd, bwd = _tp_case(n)
    y = np.asarray(fwd(xt, *tleaves))[:o].T
    got = tl.reference_forward(spec, _t(leaves), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, y, atol=FWD_REL * np.abs(y).max(), rtol=0)
    dwi, dwh, db, dwfc, dbfc = (np.array(g) for g in bwd(xt, dyt, *tleaves))
    want = [dwi.T, dwh.T, db[:, 0], dwfc[:o].T, dbfc[:o, 0]]
    grads = tl.reference_backward(spec, _t(leaves), torch.as_tensor(x), torch.as_tensor(dy))
    errs = TP_PARITY.errors(list(grads), _t(want))
    assert TP_PARITY.holds(errs), [(i, errs[i]) for i in TP_PARITY.failing(errs)]
