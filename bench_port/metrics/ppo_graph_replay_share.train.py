"""Update: the share of the PPO minibatches that replayed a CUDA graph,
the program's `graph.replay` spans under `update.ppo` over its
`graph.replay` and `graph.eager` spans there, in the traced iterations.
Nothing where the program records no spans on a card, or opens no such
span (minibatches that no graph site runs)."""


def read(record):
    try:
        from mupe_tpu_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    recs = trace.recorded()
    if not any(r["device_ms"] is not None for r in recs):
        return None
    replays = sum(r["name"] == "graph.replay" and "update.ppo" in r["path"] for r in recs)
    eager = sum(r["name"] == "graph.eager" and "update.ppo" in r["path"] for r in recs)
    return replays / (replays + eager) if replays + eager else None
