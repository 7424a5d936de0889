"""Structured logging for the operator.

The reference ships a zap-based logging config (a ``config/logging`` ConfigMap
with per-component levels, console/JSON encoders — see the chart's logging
ConfigMap and karpenter-core's operator bootstrap). This module is the
analogue: one ``configure()`` call installs a console or JSON handler on the
``karpenter_tpu`` logger hierarchy, and ``get_logger(component)`` hands out
per-component children whose levels can be overridden individually
(``component_levels={"controller.provisioning": "DEBUG"}``).
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

ROOT = "karpenter_tpu"

# -- log context (correlation ids) ------------------------------------------
# The controller kit opens a per-reconcile context carrying a correlation id
# (``reconcile_id``); every structured log line emitted inside the reconcile
# inherits it, so a slow reconcile in the logs joins to its span tree on
# /debug/traces (the kit stamps the same id on the root span) and to its
# RECONCILE_DURATION sample.
_log_ctx = threading.local()


@contextmanager
def log_context(**fields):
    """Thread-local structured-log context: fields ride every record emitted
    within the block (nested contexts merge, inner wins)."""
    prev = getattr(_log_ctx, "fields", None)
    _log_ctx.fields = {**(prev or {}), **fields}
    try:
        yield
    finally:
        _log_ctx.fields = prev


def context_fields() -> Dict[str, object]:
    return getattr(_log_ctx, "fields", None) or {}


class _ContextFilter(logging.Filter):
    """Folds the active log_context fields into each record's kv payload
    (explicit kv fields win over context on key collisions)."""

    def filter(self, record: logging.LogRecord) -> bool:
        ctx = context_fields()
        if ctx:
            record.kv = {**ctx, **(getattr(record, "kv", None) or {})}
        return True


class JSONFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "message": record.getMessage(),
        }
        extra = getattr(record, "kv", None)
        if extra:
            out.update(extra)
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


class ConsoleFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        kv = getattr(record, "kv", None)
        tail = " " + " ".join(f"{k}={v}" for k, v in kv.items()) if kv else ""
        return f"{ts} {record.levelname:<7} {record.name} {record.getMessage()}{tail}"


def configure(
    level: str = "INFO",
    fmt: str = "console",
    component_levels: Optional[Dict[str, str]] = None,
    stream=None,
) -> logging.Logger:
    """Install the operator logging config; idempotent (replaces handlers)."""
    root = logging.getLogger(ROOT)
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(JSONFormatter() if fmt == "json" else ConsoleFormatter())
    handler.addFilter(_ContextFilter())
    root.addHandler(handler)
    root.propagate = False
    for comp, lvl in (component_levels or {}).items():
        logging.getLogger(f"{ROOT}.{comp}").setLevel(
            getattr(logging, lvl.upper(), logging.INFO)
        )
    return root


def get_logger(component: str = "") -> logging.Logger:
    return logging.getLogger(f"{ROOT}.{component}" if component else ROOT)


def kv(logger: logging.Logger, level: int, msg: str, **fields) -> None:
    """Structured log line: fields ride the record and render per-encoder."""
    if logger.isEnabledFor(level):
        logger.log(level, msg, extra={"kv": fields})
