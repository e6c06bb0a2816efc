"""Deterministic evaluation of a trained policy on the card, by default on a
fixed scenario (counterpart of scripts/eval.py).

Usage: python -m mupe_tpu_torch.eval env.use_random_cylinder=false env.scenario_flag=wall \
    env.num_envs=4096 model_dir=runs/<name>/checkpoints
"""
import sys

from .harness import evaluate

if __name__ == "__main__":
    evaluate(sys.argv[1:])
