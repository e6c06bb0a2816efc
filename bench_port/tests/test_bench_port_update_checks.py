"""The training check's numbers on synthetic leaves: Adam's first steps
in plain PyTorch on leaves shaped as the encoder's (weights, and the small
biases and LayerNorm offsets where near-zero gradients sit), against
hns.train's limits.  A sign that rounding flips in one small leaf's
first step must not fail the cell; a learner that never moves, a
gradient at half its scale, or a fault confined to one parameter group
(which the medians over every leaf do not see), must."""
from __future__ import annotations

import json
import math

import pytest
import torch

from bench_port.drivers import train
from bench_port.reference.update import Adam
from conftest import BENCH
from test_bench_port_manifest import CHECKS

LIMITS = json.loads((BENCH / "workloads" / "hns.train.json").read_text())["limits"]
SHAPES = {"actor": [(64, 64), (64,), (64, 64), (64,), (64,), (64, 4), (4,)],
          "critic": [(64, 64), (64,), (64, 64), (64,), (64,), (64, 1), (1,)],
          "tp": [(16, 256), (64, 256), (256,), (64, 30), (30,)]}
LR = 5e-4


def _leaves(gen, scale=1.0):
    return {k: [scale * torch.randn(s, generator=gen, dtype=torch.float64) for s in shapes]
            for k, shapes in SHAPES.items()}


def _steps(before, grads):
    """Each group's leaves after an Adam step on each gradient in turn."""
    out = {}
    for k, leaves in before.items():
        opt, now = Adam.zeros(leaves), leaves
        for g in grads:
            now = opt.step(now, g[k], LR)
        out[k] = now
    return out


def _sides(flip=False, scale=1.0, unchanged=False, noise=1e-7, group_scale=None, frozen=None):
    """The reference's first three steps and the program's: the same
    gradients but for rounding noise, or a fault: `group_scale` (a group
    whose first gradient is scaled), `frozen` (a group the steps leave
    as it was)."""
    gen = torch.Generator().manual_seed(3)
    before = _leaves(gen)
    grads = [_leaves(gen, 0.1) for _ in range(3)]
    # a small leaf (the actor's first bias) half of whose first gradient
    # is all but nought, yet above Adam's epsilon, and whose later
    # gradients keep the first one's signs: a flip of those signs moves
    # each element by twice the learning rate against the next steps
    small = grads[0]["actor"][1]
    small[:32] *= 1e-4
    for g in grads[1:]:
        g["actor"][1] = g["actor"][1].abs() * torch.sign(small)
    prog = [{k: [g + noise * torch.randn(g.shape, generator=gen, dtype=g.dtype) for g in v]
             for k, v in step.items()} for step in grads]
    if flip:
        prog[0]["actor"][1][:32] = -grads[0]["actor"][1][:32]
    prog[0] = {k: [scale * g for g in v] for k, v in prog[0].items()}
    if group_scale is not None:
        prog[0][group_scale[0]] = [group_scale[1] * g for g in prog[0][group_scale[0]]]
    ref = {"losses": [1.0, 0.9, 0.8], "tp_losses": [], "first": grads[0], "before": before,
           "after": _steps(before, grads)}
    side = {"losses": [1.0, 0.9, 0.8], "tp_losses": [],
            "first": {k: [torch.zeros_like(g) for g in v] for k, v in prog[0].items()}
            if unchanged else prog[0],
            "after": before if unchanged else _steps(before, prog)}
    if frozen is not None:
        side["after"][frozen] = before[frozen]
    return side, ref


def _fails(got):
    return sorted(k for k, limit in LIMITS.items() if k in got and got[k] > limit)


def test_rounding_noise_reads_under_the_limits():
    got = train.update_readings(*_sides())
    assert not _fails(got), got


def test_a_sign_flipped_small_leaf_reads_under_the_limits():
    """The worst leaf's change reads far above the old limit (0.15);
    the median leaf's does not move."""
    got = train.update_readings(*_sides(flip=True))
    assert got["change"] > 0.15
    assert not _fails(got), got
    assert got["median_change"] < 1e-3 and got["median_grad"] < 1e-4


def test_a_learner_that_never_moves_reads_one_and_fails():
    got = train.update_readings(*_sides(unchanged=True))
    assert got["median_grad"] == pytest.approx(1.0) and got["median_change"] == pytest.approx(1.0)
    assert {"median_grad", "median_change"} <= set(_fails(got))


def test_a_gradient_at_half_scale_fails():
    got = train.update_readings(*_sides(scale=0.5))
    assert got["median_grad"] == pytest.approx(0.5, rel=1e-3)
    assert "median_grad" in _fails(got)


@pytest.mark.parametrize("fault", [dict(group_scale=("tp", 0.5)),
                                   dict(group_scale=("critic", 0.5)),
                                   dict(group_scale=("tp", 0.85)),
                                   dict(frozen="tp"), dict(frozen="critic")],
                         ids=["tp_grad_half", "critic_grad_half", "tp_grad_0.85",
                              "tp_step_left_out", "critic_step_left_out"])
def test_a_fault_confined_to_one_group_fails(fault):
    """The medians over every leaf stay under their limits, as the other
    groups' leaves hold them; the group's own median does not."""
    got = train.update_readings(*_sides(**fault))
    assert got["median_grad"] < LIMITS["median_grad"]
    assert got["median_change"] < LIMITS["median_change"]
    want = "group_grad" if "group_scale" in fault else "group_change"
    assert want in _fails(got), got


def test_a_missing_step_reads_infinite_on_every_update_number():
    side, ref = _sides()
    side["losses"] = side["losses"][:2]
    got = train.update_readings(side, ref)
    assert set(got) == set(train.UPDATE_NUMBERS) and all(math.isinf(v) for v in got.values())


def test_one_tail_row_moves_the_log_probs_not_the_values():
    """A row far in the tail of a narrow policy: its log-prob's gap grows
    as the inverse of the standard deviation; `act_value` stays put."""
    gen = torch.Generator().manual_seed(5)
    logp, value = (torch.randn(8, 4, 3, 1, generator=gen) for _ in range(2))
    side = (logp.clone(), value + 1e-4)
    side[0][5, 2, 1, 0] += 0.5 * logp.abs().max()
    got = train.act_readings(side, (logp, value))
    assert got["act"] == got["act_logp"] == pytest.approx(0.5, rel=1e-5)
    assert got["act_value"] < LIMITS["act_value"]


@pytest.mark.parametrize("cell", sorted(p.stem for p in (BENCH / "workloads").glob("*.json")))
def test_every_limit_names_a_number_its_driver_reads(cell):
    """The cells of `BENCHMARK.json` and those kept as files alike."""
    body = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    kind = json.loads((BENCH / "traffic" / f"{body['traffic']}.json").read_text())["kind"]
    assert body["limits"] and set(body["limits"]) <= CHECKS[kind]
    assert all(v > 0 for v in body["limits"].values())
