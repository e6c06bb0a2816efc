"""Train a depth-vision hover policy end to end at toy scale
(counterpart of examples/demo_vision_policy.py): Hover emits an onboard
depth frame beside the flat state and `ppo_vision` reads both through
`MixedObsEncoder` (the conv branch and an MLP branch).

    python -m mupe_tpu_torch.examples.demo_vision_policy [--device cpu]
"""
import torch

from mupe_tpu_torch.envs.hover import Hover, HoverCfg
from mupe_tpu_torch.examples import device_arg
from mupe_tpu_torch.learning import init_carry, make_train_iter
from mupe_tpu_torch.learning.registry import make_policy


def main(device: str = "cuda", iters: int = 30) -> None:
    env = Hover(HoverCfg(num_envs=256, max_episode_length=200, obs_depth=True, depth_width=16,
                         depth_height=12), device=device)
    policy = make_policy("ppo_vision", env, {"train_every": 16, "num_minibatches": 4}, device)
    carry = init_carry(env, policy, torch.Generator(device=device).manual_seed(0))
    it = make_train_iter(env, policy)
    print("iter  policy_loss  value_loss  pos_error  episodes")
    for i in range(iters):
        carry, metrics, stats = it(carry)
        if (i + 1) % 5 == 0:
            n_ep = float(stats["episode_count"])
            pe = float(stats["pos_error"])
            print(f"{i+1:4d}  {float(metrics['policy_loss']):+10.4f}"
                  f"  {float(metrics['value_loss']):10.4f}"
                  + (f"  {pe:9.4f}" if n_ep > 0 else "     (none)")
                  + f"  {n_ep:8.0f}")
    print("done — vision policy trained through the conv depth branch")


if __name__ == "__main__":
    main(device_arg())
