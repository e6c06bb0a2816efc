"""Data parallelism: device-stream milliseconds of rank 0's collectives
(the program's `dist.all_reduce` and `dist.all_gather` spans: the
per-step reset gate, the update's statistics and gradient sums, a
collective's wait for the slowest rank included) an iteration, in the
traced iterations.  Nothing where the program records no such span on a
card."""


def read(record):
    try:
        from mupe_tpu_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    ms = [r["device_ms"] for r in trace.recorded()
          if r["name"] in ("dist.all_reduce", "dist.all_gather") and r["device_ms"] is not None]
    return sum(ms) / record["iters_traced"] if ms and record.get("iters_traced") else None
