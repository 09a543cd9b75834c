"""Dual file+console logging, format-compatible with the reference logs
(copy of the JAX package's core/logs.py; reference setup_logger,
new_cvpr_train_behavior_things_pipeline.py:51-85, and setup_main_logger,
clip_train_behavior_sweep.py:81-109): a per-run logger and an orchestrator
("main") logger.

The port runs one process, so the file handler needs no primary-process
gate; it still opens its file at the first record, as the JAX package's
does.
"""
from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s - %(levelname)s - %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"


class _LazyFileHandler(logging.Handler):
    """Truncating (mode "w") file handler that opens at the first record."""

    def __init__(self, path: str, formatter: logging.Formatter):
        super().__init__(logging.INFO)
        self._path = path
        self._inner: logging.FileHandler | None = None
        self.setFormatter(formatter)

    def emit(self, record):
        if self._inner is None:
            d = os.path.dirname(self._path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._inner = logging.FileHandler(self._path, mode="w")
            self._inner.setLevel(logging.INFO)
            self._inner.setFormatter(self.formatter)
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
    logger.addHandler(_LazyFileHandler(log_file_path, formatter))
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
