"""Structured logging: JSON lines correlated with the active trace.

``KAFKA_TORCH_LOG_FORMAT=json`` switches every log record to one JSON
object per line, stamped with ``trace_id``/``span_id`` (from the ambient
tracing context, when the emitting code runs inside a traced request) and
``thread_id``/``thread``/``pid`` — the correlation keys that let an
operator grep a request's full story across the serving process AND its
sandbox subprocesses (which inherit the env knob through
``tracing.subprocess_env``).

Explicit ``extra={"trace_id": ...}`` fields on a record win over the
ambient context — the slow-request log uses this, since it fires from the
HTTP layer after the request's context is torn down.  Any other JSON-safe
``extra`` fields ride along verbatim (the slow log attaches its full span
breakdown this way).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Optional

ENV_FORMAT = "KAFKA_TORCH_LOG_FORMAT"

# attributes every LogRecord carries; anything else came in via extra=
_STANDARD = frozenset(
    logging.LogRecord("", 0, "", 0, "", (), None).__dict__
) | {"message", "asctime", "taskName"}


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload: dict = {
            "ts": round(record.created, 6),
            "time": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)
            ) + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
            "thread_id": record.thread,
            "thread": record.threadName,
            "pid": record.process,
        }
        # ambient trace correlation (imported lazily: logging must work
        # during interpreter teardown and partial imports)
        try:
            from . import tracing

            ctx = tracing.current()
            if ctx is not None:
                payload["trace_id"] = ctx.trace_id
                payload["span_id"] = ctx.span_id
        except Exception:
            pass
        for key, value in record.__dict__.items():
            if key in _STANDARD or key.startswith("_"):
                continue
            try:
                json.dumps(value)
            except (TypeError, ValueError):
                value = repr(value)
            payload[key] = value
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload, separators=(",", ":"), default=str)


def setup_logging(
    fmt: Optional[str] = None, level: int = logging.INFO
) -> None:
    """Install the process-wide log format (server + sandbox entrypoints).

    ``fmt`` beats the env; "json" installs :class:`JsonFormatter` on the
    root handler, anything else keeps stdlib basicConfig text.  Idempotent:
    re-running swaps the formatter rather than stacking handlers.
    """
    fmt = (fmt or os.environ.get(ENV_FORMAT, "text")).lower()
    root = logging.getLogger()
    if not root.handlers:
        logging.basicConfig(level=level)
    root.setLevel(level)
    if fmt == "json":
        formatter: logging.Formatter = JsonFormatter()
    else:
        formatter = logging.Formatter(
            "%(levelname)s:%(name)s:%(message)s"
        )
    for handler in root.handlers:
        handler.setFormatter(formatter)


def log_extra(**fields: Any) -> dict:
    """Convenience: ``logger.info(msg, extra=log_extra(trace_id=...))``."""
    return fields
