"""Dual file+console logging, format-compatible with the reference logs
(copy of the JAX package's core/logs.py; reference setup_logger,
new_cvpr_train_behavior_things_pipeline.py:51-85, and setup_main_logger,
clip_train_behavior_sweep.py:81-109): a per-run logger and an orchestrator
("main") logger.

In a multi-process run only the primary process (rank 0) writes the log
file; every rank keeps its console output.
"""
from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s - %(levelname)s - %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"


def _is_primary() -> bool:
    from ..parallel import dist
    return dist.is_primary()


class _PrimaryFileHandler(logging.Handler):
    """Truncating (mode "w") file handler of the primary process, decided
    at the first record: the log file belongs to rank 0 (the reference
    rank-gates its prints the same way, train_vit_sgd.py:149), and the
    other ranks write nothing. As the JAX package's, it decides at the
    first record, so a caller may build the logger before it joins the
    process group."""

    def __init__(self, path: str, formatter: logging.Formatter):
        super().__init__(logging.INFO)
        self._path = path
        self._inner: logging.FileHandler | None = None
        self._decided = False
        self.setFormatter(formatter)

    def emit(self, record):
        if not self._decided:
            self._decided = True
            if _is_primary():
                d = os.path.dirname(self._path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._inner = logging.FileHandler(self._path, mode="w")
                self._inner.setLevel(logging.INFO)
                self._inner.setFormatter(self.formatter)
        if self._inner is not None:
            self._inner.emit(record)

    def close(self):
        if self._inner is not None:
            self._inner.close()
        super().close()


def _build(name: str, log_file_path: str) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for h in logger.handlers:
        h.close()
    logger.handlers = []
    formatter = logging.Formatter(_FORMAT, datefmt=_DATEFMT)
    logger.addHandler(_PrimaryFileHandler(log_file_path, formatter))
    ch = logging.StreamHandler(sys.stdout)
    ch.setLevel(logging.INFO)
    ch.setFormatter(formatter)
    logger.addHandler(ch)
    return logger


def setup_logger(log_file_path: str) -> logging.Logger:
    """Per-run training logger: the run's log file and stdout."""
    return _build("training_logger", log_file_path)


def setup_main_logger(log_file_path: str) -> logging.Logger:
    """Orchestrator logger of the multi-run drivers (sweep, lengths;
    reference setup_main_logger, clip_train_behavior_sweep.py:81-109)."""
    return _build("main_training_loop", log_file_path)
