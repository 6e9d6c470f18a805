"""Logging for the port, from ``moe_infinity_tpu/utils/logger.py``: one
shared logger tree under ``moe_tpu_torch`` (apart from the JAX package's
``moe_tpu``, so a process holding both logs each record once), configured
once from ``MOE_TPU_LOG_LEVEL``."""

from __future__ import annotations

import logging
import os
import sys

_FMT = "%(asctime)s.%(msecs)03d %(levelname).1s %(name)s %(message)s"
_DATEFMT = "%H:%M:%S"

_configured = False


def init_logging(level: str | int | None = None) -> None:
    global _configured
    if _configured:
        return
    lvl = level or os.environ.get("MOE_TPU_LOG_LEVEL", "INFO")
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FMT, _DATEFMT))
    root = logging.getLogger("moe_tpu_torch")
    root.addHandler(handler)
    root.setLevel(lvl)
    root.propagate = False
    _configured = True


def get_logger(name: str = "") -> logging.Logger:
    init_logging()
    return logging.getLogger(f"moe_tpu_torch.{name}" if name else "moe_tpu_torch")
