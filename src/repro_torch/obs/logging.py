"""Logging setup for the ``repro`` stack.

Everything clique-side historically either printed or stayed silent (only
``runtime/train_loop.py`` created a logger).  This module gives the whole
tree one idempotent entry point: loggers live under the ``"repro"`` root,
``setup_logging`` attaches a single stream handler to it, and the CLIs
expose ``--log-level`` wired here.

The port's copy of the reference's ``repro/obs/logging.py``, unchanged.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional, Union

__all__ = ["setup_logging", "get_logger", "LEVELS"]

LEVELS = ("debug", "info", "warning", "error", "critical")

_FORMAT = "%(asctime)s %(levelname)-7s %(name)s: %(message)s"
_HANDLER_FLAG = "_repro_obs_handler"


def setup_logging(
    level: Union[str, int] = "warning", stream=None
) -> logging.Logger:
    """Configure the ``repro`` root logger; safe to call repeatedly.

    Re-invocation updates the level but never stacks handlers, so CLIs and
    tests can call it freely.  Returns the root ``repro`` logger.
    """
    if isinstance(level, str):
        name = level.strip().lower()
        if name not in LEVELS:
            raise ValueError(f"unknown log level {level!r}; pick from {LEVELS}")
        level = getattr(logging, name.upper())
    root = logging.getLogger("repro")
    root.setLevel(level)
    handler = None
    for h in root.handlers:
        if getattr(h, _HANDLER_FLAG, False):
            handler = h
            break
    if handler is None:
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        setattr(handler, _HANDLER_FLAG, True)
        root.addHandler(handler)
    elif stream is not None:
        handler.stream = stream
    root.propagate = False
    return root


def get_logger(name: Optional[str] = None) -> logging.Logger:
    """Get a logger under the ``repro`` namespace (``repro.<name>``)."""
    if not name:
        return logging.getLogger("repro")
    if name.startswith("repro.") or name == "repro":
        return logging.getLogger(name)
    return logging.getLogger(f"repro.{name}")
