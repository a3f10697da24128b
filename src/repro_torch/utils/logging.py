"""Tiny structured logger (no external deps)."""
from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"


def get_logger(name: str = "repro_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
