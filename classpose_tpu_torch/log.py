"""Rank-aware logging (counterpart of ``classpose_tpu/log.py``).

Per-module loggers with console output, an optional file handler from
``CLASSPOSE_LOG_PATH``, and a lower default verbosity on non-main
processes (``LOG_LEVEL_NON_MAIN``, default WARNING; ``LOG_LEVEL``, default
INFO, on the main one). The rank is the ``RANK`` environment variable,
which ``torch.distributed`` launchers set.
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"
_FILE_PATH_ENV = "CLASSPOSE_LOG_PATH"


def _process_rank() -> int:
    try:
        return int(os.getenv("RANK", "0"))
    except ValueError:
        return 0


def _default_level() -> int:
    if _process_rank() > 0:
        name = os.getenv("LOG_LEVEL_NON_MAIN", "WARNING")
    else:
        name = os.getenv("LOG_LEVEL", "INFO")
    return getattr(logging, name.upper(), logging.INFO)


def get_logger(name: str) -> logging.Logger:
    """Create (or fetch) a configured per-module logger."""
    logger = logging.getLogger(name)
    if getattr(logger, "_classpose_configured", False):
        return logger
    logger.setLevel(_default_level())
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    file_path = os.getenv(_FILE_PATH_ENV)
    if file_path:
        fh = logging.FileHandler(file_path)
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
    logger.propagate = False
    logger._classpose_configured = True  # type: ignore[attr-defined]
    return logger

