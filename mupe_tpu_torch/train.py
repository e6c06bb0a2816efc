"""Train MAPPO on a task on the card.

Usage: python -m mupe_tpu_torch.train task=HideAndSeek env.num_envs=4096 max_iters=100
"""
import sys

from .harness import train

if __name__ == "__main__":
    train(sys.argv[1:], default_task="HideAndSeek")
