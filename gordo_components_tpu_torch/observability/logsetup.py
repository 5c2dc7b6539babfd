"""Process logging setup: text or JSON lines, trace-id-stamped (the port's
copy of ``gordo_components_tpu/observability/logsetup.py``).

``--log-format json`` emits one JSON object per record, with the active
trace and span ids as fields; the text format keeps the plain line shape.
"""

from __future__ import annotations

import json
import logging

from .tracing import install_log_record_factory

TEXT_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


class JsonFormatter(logging.Formatter):
    """One JSON object per record; trace/span ids included when active."""

    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "ts": self.formatTime(record),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        trace_id = getattr(record, "trace_id", "")
        if trace_id:
            payload["trace_id"] = trace_id
        span_id = getattr(record, "span_id", "")
        if span_id:
            payload["span_id"] = span_id
        if record.exc_info:
            payload["exc_info"] = self.formatException(record.exc_info)
        return json.dumps(payload, default=str)


def configure_logging(level: str = "INFO", fmt: str = "text") -> None:
    """Install root logging at ``level`` in ``fmt`` ('text' | 'json') and
    the trace-id record factory (every record carries ``trace_id`` /
    ``span_id`` attributes from then on, whatever the handler).

    ``basicConfig`` WITHOUT ``force``, exactly like the CLI call this
    grew from: a no-op when the root logger already has handlers (a test
    runner's capture, an embedding app's own setup) — clobbering those
    would reroute their records into our stream."""
    if fmt not in ("text", "json"):
        raise ValueError(f"log format must be 'text' or 'json', got {fmt!r}")
    install_log_record_factory()
    handler = logging.StreamHandler()
    handler.setFormatter(
        JsonFormatter() if fmt == "json" else logging.Formatter(TEXT_FORMAT)
    )
    logging.basicConfig(level=level.upper(), handlers=[handler])
