"""The encoder pair forward against its roofline, by the program's kernel
spans: the sum of each `kernel.pair_fwd` span's bound (the act's rows
under `policy.act`, a minibatch's under `update.ppo`) over the sum of their
device-stream milliseconds, in the traced iterations.  A span names the
kernel's role, so the share survives a kernel's rename.  Nothing where the
program records no spans on a card."""
from bench_port import flops


def read(record):
    try:
        from mupe_tpu_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    m = record["model"]
    if m["groups"] is None:
        return None
    rows = {"policy.act": m["arenas"] * m["n_agents"], "update.ppo": m["mb_rows"]}
    bound_s = ms = 0.0
    for r in trace.recorded():
        where = [p for p in rows if p in r["path"]]
        if r["name"] == "kernel.pair_fwd" and r["device_ms"] is not None and where:
            bound_s += flops.pair_forward_bound_s(m["groups"], m["action_dim"], rows[where[0]])
            ms += r["device_ms"]
    return 100.0 * bound_s * 1e3 / ms if ms > 0 else None
