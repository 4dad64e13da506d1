"""Rank-annotated logging helpers.

A copy of ``tpu_resiliency/utils/logging.py`` rooted at the port's package logger
(``tpu_resiliency_torch``), with the same format and the same level variable,
``TPU_RESILIENCY_LOG_LEVEL``. Analogue of the reference's ``RankMonitorLogger``
rank-prefixed format (``fault_tolerance/rank_monitor_server.py:48-95``).
"""

from __future__ import annotations

import logging
import os
import sys

_FMT = "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"
_ROOT = "tpu_resiliency_torch"


def get_logger(name: str, level: int | str | None = None) -> logging.Logger:
    """Return a package logger, configuring a stderr handler once per process."""
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FMT))
        root.addHandler(handler)
        env_level = os.environ.get("TPU_RESILIENCY_LOG_LEVEL", "INFO")
        root.setLevel(env_level)
    logger = logging.getLogger(name if name.startswith(_ROOT) else f"{_ROOT}.{name}")
    if level is not None:
        logger.setLevel(level)
    return logger


class RankLoggerAdapter(logging.LoggerAdapter):
    """Prefixes every message with the rank (and optional role) emitting it."""

    def __init__(self, logger: logging.Logger, rank: int | None = None, role: str = ""):
        super().__init__(logger, {})
        self.rank = rank
        self.role = role

    def process(self, msg, kwargs):
        rank = self.rank if self.rank is not None else os.environ.get("RANK", "?")
        prefix = f"[{self.role}]" if self.role else ""
        return f"{prefix}[rank={rank}] {msg}", kwargs
