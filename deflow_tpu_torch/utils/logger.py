"""Experiment metric logging.

The port's own copy of ``deflow_tpu/utils/logger.py``.  The reference logs
through wandb (reference README.md:48,62 ``wandb_mode=``, entity
``kth-rpl``; run dirs ``logs/wandb/<model>-<slurm_id>/``, 2_eval.sh:35).
``wandb`` is optional: it is imported where a logger starts, and without it
the logger keeps the same surface (``wandb_mode=online/offline/disabled``)
and writes a local JSONL file in the same run-directory layout, which the
checkpoints and resume depend on.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricLogger:
    def __init__(
        self,
        project: str,
        run_name: str,
        mode: str = "offline",
        entity: str = "",
        output_dir: str = "logs",
        config: Optional[Dict[str, Any]] = None,
    ):
        self.mode = mode
        self.run_name = run_name
        # reference run layout: logs/wandb/<model>-<slurm_id>/checkpoints/...
        self.run_dir = os.path.join(output_dir, "wandb", run_name)
        self.ckpt_dir = os.path.join(self.run_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._wandb = None
        self._jsonl = None
        if mode != "disabled":
            try:
                import wandb  # optional dependency

                self._wandb = wandb.init(
                    project=project, entity=entity or None, name=run_name,
                    mode=mode, dir=self.run_dir, config=config or {},
                )
            except Exception:
                self._jsonl = open(os.path.join(self.run_dir, "metrics.jsonl"), "a")
                if config:
                    self._emit({"_config": config, "_ts": time.time()})

    def _emit(self, record: Dict[str, Any]) -> None:
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(record, default=float) + "\n")
            self._jsonl.flush()

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        else:
            rec = dict(metrics)
            rec["_step"] = step
            rec["_ts"] = time.time()
            self._emit(rec)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
