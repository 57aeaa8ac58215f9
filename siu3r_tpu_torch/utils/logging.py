"""Rank-prefixed logging and the metrics history, counterpart of
``siu3r_tpu/utils/logging.py`` (reference src/utils/pylogger.py:7-55): the
rank is ``torch.distributed``'s where a process group is initialised, else 0."""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path
from typing import Optional


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class RankedLogger:
    def __init__(self, name: str = "siu3r_tpu_torch", rank_zero_only: bool = False):
        self.logger = logging.getLogger(name)
        if not self.logger.handlers:
            handler = logging.StreamHandler(sys.stdout)
            handler.setFormatter(logging.Formatter("[%(asctime)s][%(name)s][%(levelname)s] %(message)s"))
            self.logger.addHandler(handler)
            self.logger.setLevel(logging.INFO)
        self.rank_zero_only = rank_zero_only

    def _log(self, level: int, msg: str, rank: Optional[int] = None) -> None:
        current = _rank()
        msg = f"[rank: {current}] {msg}"
        if self.rank_zero_only:
            if current == 0:
                self.logger.log(level, msg)
        elif rank is None or rank == current:
            self.logger.log(level, msg)

    def info(self, msg: str, rank: Optional[int] = None) -> None:
        self._log(logging.INFO, msg, rank)

    def warning(self, msg: str, rank: Optional[int] = None) -> None:
        self._log(logging.WARNING, msg, rank)

    def error(self, msg: str, rank: Optional[int] = None) -> None:
        self._log(logging.ERROR, msg, rank)

    def debug(self, msg: str, rank: Optional[int] = None) -> None:
        self._log(logging.DEBUG, msg, rank)


class MetricsHistory:
    """Experiment tracker (the reference's WandbLogger + LearningRateMonitor
    slot, src/run.py:42-48,71-81): appends one JSON object per event to
    ``metrics.jsonl`` in the run's output directory. Rank 0 only; safe to
    call from every process."""

    def __init__(self, out_dir):
        self.path = Path(out_dir) / "metrics.jsonl"
        self.enabled = _rank() == 0
        if self.enabled:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, step: int, **scalars) -> None:
        if not self.enabled:
            return
        record = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
