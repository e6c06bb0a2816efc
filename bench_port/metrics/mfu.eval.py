"""Model FLOP utilisation of evaluation: a greedy step's actor forward and
TP prediction (no value: a greedy action needs none) times the window's
steps, over the window's seconds times the bf16 peak."""
from bench_port import flops


def read(record):
    w = record["window"]
    if w["wall_s"] <= 0 or not w["evals"]:
        return None
    steps = w["evals"] * w["steps"]
    return 100.0 * record["step_flops"] * steps / (w["wall_s"] * flops.PEAK_BF16_FLOPS)
