"""Env step: device-stream milliseconds of an `env.step` call in which no
arena resets, the mean over the traced run's window (CUDA events)."""
from statistics import fmean


def read(record):
    ms = record.get("spans", {}).get("env_step", [])
    return fmean(ms) if ms else None
