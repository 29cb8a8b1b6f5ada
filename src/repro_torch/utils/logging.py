"""Minimal structured logger shared by launchers, benchmarks, and obs.

The level honors the ``REPRO_LOG_LEVEL`` environment variable (name or
number — ``REPRO_LOG_LEVEL=DEBUG`` / ``=10``; default INFO), read when
a logger is first configured. ``kv()`` renders structured key=value
lines for messages that downstream tooling greps (the ``obs`` layer
routes its warnings — e.g. trace-file write failures — through it).
"""
from __future__ import annotations

import logging
import os
import sys

_FMT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def _env_level(default: int = logging.INFO) -> int:
    raw = os.environ.get("REPRO_LOG_LEVEL", "").strip()
    if not raw:
        return default
    if raw.isdigit():
        return int(raw)
    level = logging.getLevelName(raw.upper())
    return level if isinstance(level, int) else default


def get_logger(name: str = "repro") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(_env_level())
        logger.propagate = False
    return logger


def kv(**fields) -> str:
    """``key=value`` line in call order; values with whitespace (or
    empties) are repr-quoted so the line stays grep/split-safe."""
    parts = []
    for k, v in fields.items():
        s = str(v)
        if not s or any(c.isspace() for c in s) or "=" in s:
            s = repr(s)
        parts.append(f"{k}={s}")
    return " ".join(parts)
