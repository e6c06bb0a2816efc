"""Host dispatch of the rollout: the host synchronisations the program
counts (its `sync.*` spans) inside the rollout, over the rollout's
`env.step` spans, in the traced iterations.  Nothing where the program
records no spans on a card."""


def read(record):
    try:
        from mupe_tpu_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    recs = trace.recorded()
    if not any(r["device_ms"] is not None for r in recs):
        return None
    steps = sum(r["name"] == "env.step" and "rollout" in r["path"] for r in recs)
    syncs = sum(r["name"].startswith("sync.") and "rollout" in r["path"] for r in recs)
    return syncs / steps if steps else None
