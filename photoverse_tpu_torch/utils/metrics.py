"""Metric logging for training (the port's own copy of
photoverse_tpu/utils/metrics.py): scalars always go to
`output_dir/metrics.jsonl`, one {"step", "time", ...} object per line;
TensorBoard attaches when its writer is importable, wandb when asked for
and installed (a warning otherwise), as `--report_to` selects
(tensorboard, wandb or all)."""

from __future__ import annotations

import importlib
import json
import os
import time
from typing import Dict, Optional

__all__ = ["MetricsWriter"]


class MetricsWriter:
    def __init__(self, output_dir: str, project: str = "photoVerse", report_to: str = "tensorboard",
                 config: Optional[dict] = None):
        os.makedirs(output_dir, exist_ok=True)
        self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        self._wandb = None
        self._tb = None
        if report_to in ("wandb", "all"):
            try:
                import wandb
            except ImportError:
                print("WARNING: --report_to wandb but the package is not installed; metrics go to "
                      "metrics.jsonl only")
            else:
                try:
                    self._wandb = wandb.init(project=project, config=config or {})
                except Exception as e:  # a tracker must not stop training; say so
                    print(f"WARNING: wandb.init failed ({e}); continuing without wandb "
                          "(metrics.jsonl still written)")
        if report_to in ("tensorboard", "all"):
            for mod in ("torch.utils.tensorboard", "tensorboardX"):
                try:
                    self._tb = importlib.import_module(mod).SummaryWriter(log_dir=os.path.join(output_dir, "runs"))
                    break
                except Exception:  # the package or its backend is missing
                    continue
        if config is not None:
            with open(os.path.join(output_dir, "config.json"), "w") as f:
                json.dump({k: str(v) for k, v in config.items()}, f, indent=2)

    def log(self, metrics: Dict, step: int) -> None:
        record = {"step": step, "time": time.time()}
        scalars = {}
        for k, v in metrics.items():
            try:
                scalars[k] = float(v)
            except (TypeError, ValueError):
                continue
        record.update(scalars)
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)

    def log_image(self, key: str, path: str, caption: str, step: int) -> None:
        if self._wandb is not None:
            import wandb

            self._wandb.log({key: wandb.Image(path, caption=caption)}, step=step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
