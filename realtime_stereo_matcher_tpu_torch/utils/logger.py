"""Logging utilities: ANSI colour formatter and metric logger (a copy of
the JAX package's framework-free ``realtime_stereo_matcher_tpu/utils/logger.py``;
the port imports nothing of that package).

Replaces the reference's colour formatter (tools/logger.py:7-51) and the
TensorBoard ``Logger`` (train_stereo.py:51-114) with a dependency-light
metrics writer: running means flushed every ``sum_freq`` steps to stdout and
to a JSONL scalars file.  TensorBoard event files are written beside it
where ``torch.utils.tensorboard`` imports; without it only the JSONL file is
written.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path


class ColorFormatter(logging.Formatter):
    COLORS = {
        logging.DEBUG: "\x1b[38;21m",
        logging.INFO: "\x1b[38;5;39m",
        logging.WARNING: "\x1b[38;5;226m",
        logging.ERROR: "\x1b[38;5;196m",
        logging.CRITICAL: "\x1b[31;1m",
    }
    RESET = "\x1b[0m"

    def format(self, record):
        color = self.COLORS.get(record.levelno, "")
        fmt = (f"{color}[%(levelname)s]{self.RESET} | %(asctime)s | "
               f"%(filename)s:%(lineno)d | {color}%(message)s{self.RESET}")
        return logging.Formatter(fmt).format(record)


def create_color_logger(name: str, level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setLevel(level)
        h.setFormatter(ColorFormatter())
        logger.addHandler(h)
    return logger


def setup_basic_logging():
    """The reference entry scripts' logging format (train_stereo.py:222-225)."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)-8s [%(filename)s:%(lineno)d] %(message)s",
    )


class MetricLogger:
    """Running-mean metric aggregation (reference Logger, train_stereo.py:51-114).

    Pushes per-step metric dicts; every ``sum_freq`` steps prints the means
    and appends them to ``<log_dir>/scalars.jsonl``.
    """

    def __init__(self, log_dir=None, sum_freq: int = 100, lr_fn=None,
                 tensorboard: bool = True):
        self.sum_freq = sum_freq
        self.total_steps = 0
        self.running = {}
        self.lr_fn = lr_fn
        self.log_dir = Path(log_dir) if log_dir else None
        self._fp = None
        self._tb = None
        if self.log_dir:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            self._fp = open(self.log_dir / "scalars.jsonl", "a")
            if tensorboard:
                try:  # TB event files like the reference Logger
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:  # no tensorboard package: JSONL only
                    SummaryWriter = None
                if SummaryWriter is not None:
                    self._tb = SummaryWriter(log_dir=str(self.log_dir))

    def write_scalars(self, step: int, scalars: dict):
        if self._fp:
            rec = {"step": step, "time": time.time(), **{
                k: float(v) for k, v in scalars.items()}}
            self._fp.write(json.dumps(rec) + "\n")
            self._fp.flush()
        if self._tb:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def push(self, metrics: dict, step: int | None = None):
        """Accumulate one step's metrics; ``step`` is the GLOBAL step (pass
        it on resumed runs -- the internal push counter restarts at 0 and
        would mislabel the printed/written rows otherwise)."""
        self.total_steps += 1
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)
        if self.total_steps % self.sum_freq == self.sum_freq - 1:
            s = self.total_steps if step is None else step
            means = {k: v / self.sum_freq for k, v in self.running.items()}
            lr = self.lr_fn(s) if self.lr_fn else float("nan")
            metrics_str = ", ".join(f"{k}:{v:.4f}" for k, v in means.items())
            logging.info(
                f"Training Metrics (step {s + 1}, session "
                f"{self.total_steps}): [{s + 1:6d}, {lr:10.7f}] "
                f"{metrics_str}")
            self.write_scalars(s, means)
            self.running = {}

    def close(self):
        if self._fp:
            self._fp.close()
        if self._tb:
            self._tb.close()
