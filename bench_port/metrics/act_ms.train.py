"""Policy act: device-stream milliseconds of a `policy.act` call in the
rollout, the mean over the traced run's window (CUDA events)."""
from statistics import fmean


def read(record):
    ms = record.get("spans", {}).get("act", [])
    return fmean(ms) if ms else None
