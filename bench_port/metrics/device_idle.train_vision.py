"""The device's idle share in ppo_vision's training: one less the device's
busy time in the traced iterations (the union of its operations) over the
wall time of as many iterations untraced."""


def read(record):
    wall = record["untraced_wall_s"]
    return 100.0 * max(0.0, 1.0 - record["busy_s"] / wall) if wall > 0 else None
