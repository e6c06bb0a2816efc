"""Host dispatch of evaluation: the launch calls (kernels, graphs) over the
traced greedy steps."""
from bench_port import tracing


def read(record):
    n = tracing.launches_in(record["trace"], "eval")
    return n / record["steps_traced"] if n else None
