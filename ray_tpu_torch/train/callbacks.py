"""Result-logging callbacks (counterpart of
``ray_tpu/train/callbacks.py``): local JSONL and CSV loggers, and the
base class that a tracker's integration would subclass.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List, Optional


class Callback:
    """Lifecycle hooks invoked by DataParallelTrainer.fit (and anything else that
    produces a result stream)."""

    def on_result(self, metrics: Dict[str, Any]) -> None:  # per report
        pass

    def on_end(self, result) -> None:  # final Result
        pass


class JsonLoggerCallback(Callback):
    """Appends one JSON line per reported result to ``<dir>/result.json``
    (the reference's result.json contract)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "result.json")

    def on_result(self, metrics: Dict[str, Any]) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(metrics, default=str) + "\n")


class CSVLoggerCallback(Callback):
    """Appends reported results to ``<dir>/progress.csv``, widening the
    header union-of-keys style like the reference's CSV logger."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "progress.csv")
        self._fields: Optional[List[str]] = None

    def on_result(self, metrics: Dict[str, Any]) -> None:
        if self._fields is None:
            self._fields = sorted(metrics)
            with open(self.path, "w", newline="") as f:
                csv.DictWriter(f, fieldnames=self._fields).writeheader()
        with open(self.path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self._fields,
                           extrasaction="ignore").writerow(
                {k: metrics.get(k) for k in self._fields})
