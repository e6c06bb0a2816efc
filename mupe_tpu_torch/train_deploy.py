"""Stage-2 deployment refinement on the card: HideAndSeek with the
smoothness reward on and its coefficient ramped by the training iteration
(counterpart of scripts/train_deploy.py); start from a stage-1 checkpoint.

Usage: python -m mupe_tpu_torch.train_deploy model_dir=runs/<name>/checkpoints \
    env.smooth_lr=0.01 max_iters=100
"""
import sys

from .harness import train

if __name__ == "__main__":
    train(sys.argv[1:], default_task="HideAndSeek", deploy_stage=True)
