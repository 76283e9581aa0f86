"""Message-only logger to a file and stdout (port of
linr_pcgc_tpu/utils/logging.py)."""

from __future__ import annotations

import logging
import sys


def set_logger(logpath: str, name: str = "linr_pcgc_tpu_torch") -> logging.Logger:
    """Message-only logger to ``logpath`` and stdout."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(message)s")
    for h in (logging.FileHandler(logpath, mode="a", encoding="utf-8"),
              logging.StreamHandler(sys.stdout)):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger
