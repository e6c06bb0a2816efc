"""Train with the Adaptive Environment Generator (task HideAndSeek_envgen)
on the card.

Usage: python -m mupe_tpu_torch.train_generator env.num_envs=4096 max_iters=100
"""
import sys

from .harness import train

if __name__ == "__main__":
    train(sys.argv[1:], default_task="HideAndSeek_envgen")
