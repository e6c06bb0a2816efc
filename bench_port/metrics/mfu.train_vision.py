"""Model FLOP utilisation of ppo_vision's training against the float32
peak (its networks run in float32, with TF32 off): the operations an
iteration's forward and backward passes need (every step's act of both
networks, the bootstrap value, every minibatch's forward and backward of
both; the backbone, the MLPs and the heads) times the window's
iterations, over the window's seconds times 67 TFLOP/s."""
from bench_port.flops import mobilenet


def read(record):
    w = record["window"]
    if w["wall_s"] <= 0 or not w["iters"]:
        return None
    return 100.0 * record["iter_flops"] * w["iters"] / (w["wall_s"] * mobilenet.PEAK_F32_FLOPS)
