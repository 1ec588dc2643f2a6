"""Structured training logs: a rotating file logger and a jsonl metrics
stream.

A copy of `setok_tpu/utils/logging.py`: `build_logger` (console plus a
daily-rotating file) and `MetricsLogger`, which writes one JSON line per
step with wall-clock times. The training CLIs write `metrics.jsonl` under
`--output-dir` through it.
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np

_handlers: Dict[str, logging.Handler] = {}


def build_logger(logger_name: str, logger_filename: str,
                 log_dir: str = ".") -> logging.Logger:
    """Console + daily-rotating file logger (utils.py:19-59)."""
    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")
    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        stream = logging.StreamHandler(sys.stdout)
        stream.setFormatter(formatter)
        logger.addHandler(stream)
        os.makedirs(log_dir, exist_ok=True)
        filename = os.path.join(log_dir, logger_filename)
        if filename not in _handlers:
            fh = logging.handlers.TimedRotatingFileHandler(
                filename, when="D", utc=True)
            fh.setFormatter(formatter)
            _handlers[filename] = fh
        logger.addHandler(_handlers[filename])
    return logger


class MetricsLogger:
    """jsonl metrics writer with wall-clock throughput."""

    def __init__(self, path: Optional[str] = None, print_every: int = 1):
        self.path = path
        self.print_every = print_every
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._file = open(path, "a") if path else None
        self._t0 = time.time()
        self._last = self._t0

    def log(self, step: int, metrics: Dict[str, Any], **extra) -> None:
        now = time.time()
        rec = {"step": int(step), "time": round(now - self._t0, 3),
               "step_time": round(now - self._last, 4)}
        self._last = now
        for k, v in {**metrics, **extra}.items():
            try:
                rec[k] = float(np.asarray(v))
            except (TypeError, ValueError):
                rec[k] = str(v)
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        if self.print_every and step % self.print_every == 0:
            parts = " ".join(f"{k}={v:.4g}" for k, v in rec.items()
                             if isinstance(v, float) and k not in
                             ("time", "step_time"))
            print(f"[step {step}] {parts} ({rec['step_time']:.2f}s)")

    def close(self):
        if self._file:
            self._file.close()
