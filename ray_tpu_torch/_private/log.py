"""Minimal structured logging for the runtime's host threads (copy of
``ray_tpu/_private/log.py`` under the ``ray_tpu_torch`` logger).

Background loops (the Serve controller's reconcile and prefix polls)
survive transient failures, and log what they swallow here: ``debug``
for what a retry absorbs, ``warning`` for what should not happen but is
survivable. The ``ray_tpu_torch`` logger gets one stderr handler,
configured lazily; ``RAY_TPU_LOG_LEVEL`` (``_private/config.py``) sets
its threshold, default ``warning``.
"""

from __future__ import annotations

import logging
import sys
import threading

_ROOT = "ray_tpu_torch"
_configure_lock = threading.Lock()
_configured = False


def _configure() -> None:
    global _configured
    with _configure_lock:
        if _configured:
            return
        _configured = True
        root = logging.getLogger(_ROOT)
        if root.handlers:
            return  # the embedding app configured logging itself
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "[ray_tpu_torch %(levelname).1s %(name)s] %(message)s"))
        root.addHandler(handler)
        root.propagate = False
        from ray_tpu_torch._private.config import GlobalConfig

        level = str(GlobalConfig.log_level).upper()
        root.setLevel(getattr(logging, level, logging.WARNING))


def get_logger(name: str) -> logging.Logger:
    """Logger under the ``ray_tpu_torch`` hierarchy; accepts
    ``__name__`` or a bare suffix."""
    _configure()
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)
