"""Request trace ids (the port's copy of the trace-id half of
``gordo_components_tpu/observability/tracing.py``).

The server adopts the client's ``X-Gordo-Trace-Id`` (or mints one), echoes
it in the response and binds it to a context variable for the request, and
a ``logging`` record factory stamps it onto every log record emitted while
the request is served, engine logs included.
"""

from __future__ import annotations

import logging
import uuid
from contextvars import ContextVar

TRACE_HEADER = "X-Gordo-Trace-Id"

_trace_id: ContextVar[str] = ContextVar("gordo_trace_id", default="")


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def set_trace_id(trace_id: str):
    """Bind ``trace_id`` to the current context; returns the reset token."""
    return _trace_id.set(trace_id)


def reset_trace_id(token) -> None:
    _trace_id.reset(token)


_factory_installed = False


def install_log_record_factory() -> None:
    """Stamp ``record.trace_id`` onto every log record from the active
    context. Idempotent; wraps whatever factory is installed."""
    global _factory_installed
    if _factory_installed:
        return
    _factory_installed = True
    previous = logging.getLogRecordFactory()

    def factory(*args, **kwargs):
        record = previous(*args, **kwargs)
        record.trace_id = _trace_id.get()
        return record

    logging.setLogRecordFactory(factory)
