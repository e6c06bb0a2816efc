"""The encoder pair forward of the greedy acts against its roofline, over
the traced steps of an evaluation."""
from bench_port import flops, tracing

KERNELS = ("encoder_fwd", "encoder_embed")


def read(record):
    m = record["model"]
    t = tracing.kernel_seconds(record["trace"], KERNELS, "act")
    if t <= 0:
        return None
    return (100.0 * record["steps_traced"]
            * flops.pair_forward_bound_s(m["groups"], m["action_dim"], m["rows"]) / t)
