"""HideAndSeek scripted rollout: step the full task (PID-rate CTBR ->
dynamics -> evader potential field -> reward) with a naive pursuit policy
and print episode stats; `--gif` writes the first arena's episode as
demo_hideandseek.gif (counterpart of examples/demo_hideandseek_rollout.py).

    python -m mupe_tpu_torch.examples.demo_hideandseek_rollout [--device cpu] [--gif]

4 arenas, 200 steps, no TP net, no training.  Episodes end together at the
last step, so the one reset draws after every printed number and every
frame is taken.
"""
import argparse
from typing import Optional

import torch

from mupe_tpu_torch.envs import HideAndSeek, HideAndSeekCfg
from mupe_tpu_torch.envs.hideandseek import HideAndSeekState
from mupe_tpu_torch.utils.render import episode_video

STATS = ("success", "catch_reward", "distance_reward", "collision", "first_capture_step")
FRAME_KEYS = ("target_pos", "cylinders", "capture")


def chase_action(state: HideAndSeekState) -> torch.Tensor:
    """Naive pursuit: pitch toward the evader, hover-ish thrust; [rate_roll,
    rate_pitch, rate_yaw, thrust] before the tanh."""
    rpos = state.target_pos - state.drone.pos                     # [E, n, 3]
    yaw_err = torch.atan2(rpos[..., 1], rpos[..., 0])
    pitch = torch.clamp(torch.linalg.vector_norm(rpos[..., :2], dim=-1), 0.0, 0.3)
    climb = torch.clamp(rpos[..., 2], -0.3, 0.3)
    return torch.stack([torch.zeros_like(pitch), 0.3 * pitch, 0.5 * yaw_err, 0.1 * climb], -1)


def main(device: str = "cuda", gif: Optional[str] = None,
         state: Optional[HideAndSeekState] = None) -> None:
    """The rollout from `state` (the env's reset from seed 0 by default);
    with `gif`, arena 0's episode is written there."""
    cfg = HideAndSeekCfg(num_envs=4, max_episode_length=200, use_tp_net=False)
    env = HideAndSeek(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    state = env.reset(gen) if state is None else state
    sums = {k: torch.zeros((), device=device) for k in STATS}
    n_done = torch.zeros((), device=device)
    frames = {k: [] for k in ("drone_pos",) + FRAME_KEYS}
    for _ in range(cfg.max_episode_length):
        state, tr = env.step(state, chase_action(state), gen)
        done = tr.done.float()
        n_done += done.sum()
        for k in STATS:
            sums[k] += (tr.stats[k] * done).sum()
        frames["drone_pos"].append(tr.info["drone_state"][..., :3])
        for k in FRAME_KEYS:
            frames[k].append(tr.info[k])
    n = int(n_done)
    if n == 0:
        print("no episodes completed within max_episode_length — "
              "stats unavailable (raise max_episode_length or num_envs)")
    else:
        print(f"episode stats (scripted chase policy, {n} episodes):")
        for k in STATS:
            print(f"  {k:22s} {float(sums[k]) / n:8.3f}")
    if gif:
        host = {k: torch.stack(v).cpu().numpy() for k, v in frames.items()}  # [T, E, ...]
        print(f"gif: {episode_video(host, cfg, gif, env_index=0)}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--gif", action="store_true")
    args = parser.parse_args()
    main(args.device, "demo_hideandseek.gif" if args.gif else None)
