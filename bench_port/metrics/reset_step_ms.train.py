"""Auto-reset: device-stream milliseconds of an `env.step` call in which
the arenas reset (their episodes end together), the mean over the traced
run's window; nothing where the window held no reset."""
from statistics import fmean


def read(record):
    ms = record.get("spans", {}).get("reset_step", [])
    return fmean(ms) if ms else None
