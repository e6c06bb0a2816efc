"""Host dispatch of the rollout: the launch calls (kernels, graphs) the
host made while the rollout ran, over its steps, in the traced iterations."""
from bench_port import tracing


def read(record):
    steps = record["iters_traced"] * record["steps"]
    n = tracing.launches_in(record["trace"], "rollout")
    return n / steps if n and steps else None
