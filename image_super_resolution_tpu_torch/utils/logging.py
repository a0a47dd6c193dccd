"""Metrics logging: JSONL always, TensorBoard when importable (counterpart of
the JAX package's ``utils/logging.py``, same tags and file names)."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np


class MetricsLogger:
    """``enabled=False`` makes every method a no-op: data-parallel training
    passes True on rank 0 only, so one process writes the streams."""

    def __init__(self, work_dir: str | Path, run_name: str = "run",
                 use_tensorboard: bool = True, enabled: bool = True):
        self.work_dir = Path(work_dir)
        self.enabled = bool(enabled)
        self._tb = self._jsonl = None
        if not self.enabled:
            return
        self.work_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.work_dir / f"{run_name}_metrics.jsonl", "a")
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # tensorboard is not installed
                pass
            else:
                self._tb = SummaryWriter(self.work_dir.as_posix(), comment=run_name,
                                         flush_secs=30, max_queue=200)

    def scalar(self, tag: str, value: float, step: int) -> None:
        if not self.enabled:
            return
        self._jsonl.write(json.dumps({"t": time.time(), "tag": tag, "value": float(value),
                                      "step": int(step)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def scalars(self, metrics: Dict[str, Any], step: int) -> None:
        for tag, value in metrics.items():
            self.scalar(tag, float(value), step)

    def images(self, tag: str, batch_u8, step: int) -> None:
        """Log an NHWC uint8 image batch to TensorBoard (the first 10 hr/lr
        batches of a run, a visual check of the input pipeline)."""
        if self._tb is not None:
            self._tb.add_images(tag, np.asarray(batch_u8), step, dataformats="NHWC")

    def flush(self) -> None:
        if not self.enabled:
            return
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if not self.enabled:
            return
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
