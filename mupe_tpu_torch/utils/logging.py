"""Run logging: CSV always, wandb when it imports and is enabled
(counterpart of mupe_tpu/utils/logging.py).  CSV is the always-on sink, so a
headless run stays inspectable without network egress.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


class RunLogger:
    def __init__(
        self,
        run_dir: str | Path,
        run_name: Optional[str] = None,
        wandb_mode: str = "disabled",
        wandb_project: str = "mupe_tpu",
        wandb_entity: Optional[str] = None,
        config: Optional[Dict[str, Any]] = None,
    ):
        stamp = time.strftime("%Y%m%d-%H%M%S")
        self.dir = Path(run_dir) / (run_name or stamp)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._csv_path = self.dir / "metrics.csv"
        self._csv_file = None
        self._writer = None
        self._fields = None
        if config is not None:
            with open(self.dir / "config.json", "w") as f:
                json.dump(config, f, indent=2, default=str)
        self._wandb = None
        if wandb_mode != "disabled":
            try:
                import wandb

                self._wandb = wandb.init(
                    project=wandb_project,
                    entity=wandb_entity,
                    name=run_name,
                    mode=wandb_mode,
                    config=config,
                )
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        row = {"step": step}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        if self._writer is None or set(row) - set(self._fields):
            self._reopen(sorted(set(row) | set(self._fields or [])))
        self._writer.writerow(row)
        self._csv_file.flush()
        if self._wandb is not None:
            self._wandb.log(row, step=step)

    def _reopen(self, fields):
        rows = []
        if self._csv_path.exists():
            with open(self._csv_path) as f:
                rows = list(csv.DictReader(f))
        self._fields = list(fields)
        self._csv_file = open(self._csv_path, "w", newline="")
        self._writer = csv.DictWriter(
            self._csv_file, fieldnames=self._fields, restval=""
        )
        self._writer.writeheader()
        for r in rows:
            self._writer.writerow({k: r.get(k, "") for k in self._fields})

    def close(self) -> None:
        if self._csv_file is not None:
            self._csv_file.close()
        if self._wandb is not None:
            self._wandb.finish()


def config_dict(*cfgs) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for cfg in cfgs:
        if cfg is None:
            continue
        name = type(cfg).__name__
        out[name] = dataclasses.asdict(cfg)
    return out
