"""Update: device-stream milliseconds of a minibatch's actor step (the
program's `update.actor` span: forward, loss, backward, clip and Adam),
the mean over the traced iterations.  Nothing where the program records
no such span on a card."""
from statistics import fmean


def read(record):
    try:
        from mupe_tpu_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    ms = [r["device_ms"] for r in trace.recorded()
          if r["name"] == "update.actor" and r["device_ms"] is not None]
    return fmean(ms) if ms else None
