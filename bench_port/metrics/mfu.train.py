"""Model FLOP utilisation of training: the operations an iteration's
forward and backward passes need (acts, TP predictions, the bootstrap
value, the TP step, the minibatches; no recomputation, no optimizer)
times the window's iterations, over the window's seconds times the bf16
peak."""
from bench_port import flops


def read(record):
    w = record["window"]
    if w["wall_s"] <= 0 or not w["iters"]:
        return None
    return 100.0 * record["iter_flops"] * w["iters"] / (w["wall_s"] * flops.PEAK_BF16_FLOPS)
