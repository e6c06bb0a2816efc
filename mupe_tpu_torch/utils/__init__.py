"""Run plumbing: config overrides, logging, checkpoints."""
