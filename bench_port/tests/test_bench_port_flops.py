"""The frozen operation and byte counts against counts done by hand for
the cells' shapes."""
from __future__ import annotations

import pytest

from bench_port import flops

# HideAndSeek's entity groups in order: state_self 1 x 35, cylinders 3 x 5,
# state_others 2 x 3 (6 tokens, 56 columns); embed and feed-forward 128
HNS = ((1, 35), (3, 5), (2, 3))


def test_encoder_forward_by_hand():
    # per row, in multiply-adds: embeds 56*128 = 7,168; q (first token)
    # 16,384; k and v over 6 tokens 2*6*16,384 = 196,608; scores and the
    # weighted sum 2*6*128 = 1,536; out projection 16,384; feed-forward
    # 2*16,384 = 32,768; head 128*4 = 512 (actor) or 128 (critic)
    actor = 7168 + 16384 + 196608 + 1536 + 16384 + 32768 + 512
    assert actor == 271360
    assert flops.encoder_flops(HNS, 4, 1) == 2 * actor
    assert flops.encoder_flops(HNS, 1, 12288) == 2 * 12288 * (actor - 512 + 128)


def test_encoder_forward_backward_by_hand():
    # three times the forward, less the observation's gradient (56 x 128 a row)
    assert flops.encoder_fwd_bwd_flops(HNS, 4, 49152) == (3 * 2 * 49152 * 271360
                                                          - 2 * 49152 * 56 * 128)


def test_encoder_params_by_hand():
    # embeds (56 + 3 biases) x 128 ... : 36*128+128 + 5*128+128 + 3*128+128,
    # LN0 256, q k v o 4*(16,384 + 128), LN1 256, FFN 2*16,384 + 256, LN2
    # 256, head 128*4 + 4
    assert flops.encoder_params(HNS, 4) == (35 * 128 + 128 + 5 * 128 + 128 + 3 * 128 + 128
                                            + 256 + 4 * 16512 + 256 + 32768 + 256 + 256
                                            + 516)


def test_tp_by_hand():
    # F = 16 (progress, target position and velocity, 3 drone positions),
    # 10 steps, hidden 64, 15 outputs: per window 10*4*64*(16+64) + 64*15
    assert flops.tp_flops(16, 10, 15, 1) == 2 * (204800 + 960)
    # backward: the head's two products and per step wi, wh and dh
    assert flops.tp_fwd_bwd_flops(16, 10, 15, 1) == 2 * (204800 + 960) + 2 * (
        2 * 64 * 15 + 10 * 4 * 64 * (16 + 128))


def test_mlp_by_hand():
    # Hover's 20 observation columns, (256, 256, 256), 4 actions
    assert flops.mlp_flops(20, (256, 256, 256), 4, 1) == 2 * (5120 + 65536 + 65536 + 1024)
    assert flops.mlp_fwd_bwd_flops(20, (256, 256, 256), 1, 10) == (
        3 * 2 * 10 * (5120 + 131072 + 256) - 2 * 10 * 5120)


@pytest.mark.parametrize("rows", [12288, 49152])
def test_pair_forward_is_bound_by_operations(rows):
    ops = flops.encoder_flops(HNS, 4, rows) + flops.encoder_flops(HNS, 1, rows)
    assert flops.pair_forward_bound_s(HNS, 4, rows) == pytest.approx(
        ops / flops.PEAK_BF16_FLOPS)


def test_pair_backward_bound():
    ops = flops.encoder_fwd_bwd_flops(HNS, 4, 49152) + flops.encoder_fwd_bwd_flops(HNS, 1, 49152)
    assert flops.pair_backward_bound_s(HNS, 4, 49152) == pytest.approx(
        ops / flops.PEAK_BF16_FLOPS)
    assert flops.PEAK_BF16_FLOPS == 989e12 and flops.PEAK_BYTES_PER_S == 3.35e12
