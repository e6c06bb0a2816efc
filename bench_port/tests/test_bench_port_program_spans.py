"""The readers of the program's spans (`mupe_tpu_torch/utils/trace.py`) on a
hand-made recording: each value from the records, and nothing where the
program recorded nothing on a card."""
from __future__ import annotations

import pytest

from bench_port import core, flops
from conftest import BENCH

GROUPS = ((1, 16), (2, 6), (5, 5))
MODEL = dict(groups=GROUPS, obs_dim=53, n_agents=3, action_dim=4, hidden=[256, 256], arenas=64,
             steps=4, minibatches=2, epochs=1, mb_rows=384,
             tp=dict(in_dim=16, out=15, steps=10, windows=192))
READERS = ("host_syncs_per_step.train", "tp_update_ms.train", "ppo_ms.train",
           "kernel_pair_fwd_roofline.train", "kernel_pair_bwd_roofline.train",
           "kernel_tp_roofline.train")


def reader(name):
    return core.load_module(BENCH / "metrics" / f"{name}.py",
                            f"bench_port_metric_{name.replace('.', '_')}")


def _rec(name, path, device_ms):
    return {"name": name, "path": tuple(path), "device_ms": device_ms, "host_ms": 1.0}


def recording(device=True):
    """One iteration: 2 steps (one with an AEG sync besides the gate's),
    2 acts, one TP step (a forward and two backward chunks), two
    minibatches' pair forward and backward."""
    ms = (lambda v: v) if device else (lambda v: None)
    it, roll, step = ["train.iter"], ["train.iter", "rollout"], ["train.iter", "rollout",
                                                                   "env.step"]
    tp, ppo = ["train.iter", "update", "update.tp"], ["train.iter", "update", "update.ppo"]
    out = [_rec("train.iter", [], ms(100.0)), _rec("rollout", it, ms(40.0))]
    for _ in range(2):
        out += [_rec("policy.act", roll, ms(1.0)),
                _rec("kernel.pair_fwd", roll + ["policy.act"], ms(0.5)),
                _rec("env.step", roll, ms(10.0)), _rec("sync.any_across", step, ms(0.1))]
    out += [_rec("sync.aeg_update_iter", step + ["env.reset"], ms(0.2)),
            _rec("update", it, ms(60.0)), _rec("update.prep", it + ["update"], ms(2.0)),
            _rec("kernel.encoder_fwd", it + ["update", "update.prep"], ms(0.3)),
            _rec("update.tp", it + ["update"], ms(8.0)), _rec("kernel.tp_fwd", tp, ms(1.0)),
            _rec("kernel.tp_bwd", tp, ms(2.0)), _rec("kernel.tp_weight_grad",
                                                     tp + ["kernel.tp_bwd"], ms(0.5)),
            _rec("kernel.tp_bwd", tp, ms(2.0)), _rec("update.ppo", it + ["update"], ms(50.0))]
    for _ in range(2):
        out += [_rec("kernel.pair_fwd", ppo, ms(1.5)), _rec("kernel.pair_bwd", ppo, ms(4.0)),
                _rec("kernel.weight_grad", ppo + ["kernel.pair_bwd"], ms(1.0))]
    return out


@pytest.fixture
def recorded(monkeypatch):
    from mupe_tpu_torch.utils import trace

    def use(recs):
        monkeypatch.setattr(trace, "recorded", lambda: recs)
    return use


def test_each_reader_reads_its_spans(recorded):
    recorded(recording())
    got = {name: reader(name).read({"model": MODEL}) for name in READERS}
    rows_act = MODEL["arenas"] * MODEL["n_agents"]
    fwd = 2 * (flops.pair_forward_bound_s(GROUPS, 4, rows_act)
               + flops.pair_forward_bound_s(GROUPS, 4, MODEL["mb_rows"]))
    bwd = 2 * flops.pair_backward_bound_s(GROUPS, 4, MODEL["mb_rows"])
    tp = flops.bound_s(flops.tp_fwd_bwd_flops(16, 10, 15, 192), 0)
    want = {"host_syncs_per_step.train": 3 / 2, "tp_update_ms.train": 8.0,
            "ppo_ms.train": 50.0,
            "kernel_pair_fwd_roofline.train": 100.0 * fwd * 1e3 / (2 * 0.5 + 2 * 1.5),
            "kernel_pair_bwd_roofline.train": 100.0 * bwd * 1e3 / (2 * 4.0),
            "kernel_tp_roofline.train": 100.0 * tp * 1e3 / (1.0 + 2 * 2.0)}
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("recs", [[], recording(device=False)], ids=["none", "host only"])
def test_nothing_recorded_on_a_card_reads_nothing(recorded, recs):
    recorded(recs)
    assert all(reader(name).read({"model": MODEL}) is None for name in READERS)


def test_a_flat_network_or_no_tp_net_reads_no_kernel_roofline(recorded):
    recorded(recording())
    flat = dict(MODEL, groups=None, tp=None)
    for name in ("kernel_pair_fwd_roofline.train", "kernel_pair_bwd_roofline.train",
                 "kernel_tp_roofline.train"):
        assert reader(name).read({"model": flat}) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    import sys

    import mupe_tpu_torch.utils

    monkeypatch.delattr(mupe_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "mupe_tpu_torch.utils.trace", None)
    assert all(reader(name).read({"model": MODEL}) is None for name in READERS)
