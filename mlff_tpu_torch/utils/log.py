"""Logging with a DONE level and simple progress callbacks.

Replaces the reference's colored logger + ANSI progress-bar protocol
(reference: sgdml/__init__.py:45-123, sgdml/utils/ui.py:60-160) with plain
logging; the callback protocol (current, total, disp_str=..., sec_disp_str=...)
is preserved so orchestration code can thread progress through long ops.
"""

from __future__ import annotations

import logging
import sys
import time

DONE_LEVEL = 25
logging.addLevelName(DONE_LEVEL, "DONE")


def get_logger(name: str = "mlff_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("[%(levelname)s] %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


class ProgressCallback:
    """Minimal stand-in for the reference ui.callback protocol."""

    def __init__(self, logger: logging.Logger | None = None, every_s: float = 5.0):
        self.logger = logger or get_logger()
        self.every_s = every_s
        self._last = 0.0

    def __call__(self, current, total=None, disp_str="", sec_disp_str=None, **kw):
        now = time.monotonic()
        if total is not None and current != total and now - self._last < self.every_s:
            return
        self._last = now
        if total:
            self.logger.info("%s: %s/%s %s", disp_str, current, total, sec_disp_str or "")
        else:
            self.logger.info("%s %s", disp_str, sec_disp_str or "")
