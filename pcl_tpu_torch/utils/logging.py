"""Leveled console logging (reference: common/console/print.h:74-125).

Counterpart of ``pcl_tpu/utils/logging.py``: PCL's ERROR/WARN/INFO/DEBUG
levels on Python's logging. The port logs under its own root,
``pcl_tpu_torch``, so that setting the verbosity of one package leaves the
other's alone; the levels and the ``PCL_TPU_VERBOSITY`` variable are the
JAX package's.
"""

from __future__ import annotations

import logging
import os

_ROOT = "pcl_tpu_torch"

_LEVELS = {
    "ALWAYS": logging.CRITICAL,
    "ERROR": logging.ERROR,
    "WARN": logging.WARNING,
    "INFO": logging.INFO,
    "DEBUG": logging.DEBUG,
    "VERBOSE": 5,
}


def get_logger(name: str = "") -> logging.Logger:
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)


def set_verbosity(level: str) -> None:
    """Set the package's verbosity (reference pcl::console::setVerbosityLevel)."""
    logging.getLogger(_ROOT).setLevel(_LEVELS[level.upper()])


def _init() -> None:
    logger = logging.getLogger(_ROOT)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("[%(name)s %(levelname)s] %(message)s"))
        logger.addHandler(handler)
    logger.setLevel(_LEVELS.get(os.environ.get("PCL_TPU_VERBOSITY", "WARN").upper(),
                                logging.WARNING))


_init()
