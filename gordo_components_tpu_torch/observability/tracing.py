"""Request tracing: context-variable trace and span ids propagated over HTTP
(the port's copy of ``gordo_components_tpu/observability/tracing.py``).

One header, ``X-Gordo-Trace-Id``, rides every client request: the server
adopts it (or mints one), echoes it in the response and binds it to a
context variable for the request, and a ``logging`` record factory stamps
the current trace and span ids onto every log record emitted on that
request's context, engine logs included.

Context variables, not thread-locals: work that crosses to another thread
(the engine's leader and collector) carries the ids explicitly
(``observability/spans.py``: ``capture`` and ``bind``).
"""

from __future__ import annotations

import contextlib
import logging
import time
import uuid
from contextvars import ContextVar
from typing import Iterator, Optional

TRACE_HEADER = "X-Gordo-Trace-Id"

_trace_id: ContextVar[str] = ContextVar("gordo_trace_id", default="")
_span_id: ContextVar[str] = ContextVar("gordo_span_id", default="")

logger = logging.getLogger(__name__)


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def get_trace_id() -> str:
    """The current context's trace id ('' when none is active)."""
    return _trace_id.get()


def set_trace_id(trace_id: str):
    """Bind ``trace_id`` to the current context; returns the reset token."""
    return _trace_id.set(trace_id)


def reset_trace_id(token) -> None:
    _trace_id.reset(token)


def current_or_new() -> str:
    """The active trace id, or a fresh one (NOT bound: a caller starting a
    new trace binds it with :func:`trace` or :func:`set_trace_id`)."""
    return _trace_id.get() or new_trace_id()


@contextlib.contextmanager
def trace(trace_id: Optional[str] = None) -> Iterator[str]:
    """Bind a trace id (given or fresh) for the duration of the block."""
    tid = trace_id or new_trace_id()
    token = _trace_id.set(tid)
    try:
        yield tid
    finally:
        _trace_id.reset(token)


@contextlib.contextmanager
def span(name: str) -> Iterator[str]:
    """A named timed unit inside the current trace: binds a fresh span id,
    logs the duration at DEBUG and observes it into the registry
    (``gordo_span_seconds{name}``)."""
    from .registry import REGISTRY

    sid = uuid.uuid4().hex[:8]
    token = _span_id.set(sid)
    started = time.perf_counter()
    try:
        yield sid
    finally:
        elapsed = time.perf_counter() - started
        _span_id.reset(token)
        REGISTRY.histogram(
            "gordo_span_seconds",
            "Duration of named trace spans",
            labels=("name",),
        ).labels(name).observe(elapsed)
        logger.debug("span %s (%s): %.3f ms", name, sid, elapsed * 1000)


def get_span_id() -> str:
    return _span_id.get()


_factory_installed = False


def install_log_record_factory() -> None:
    """Stamp ``record.trace_id`` and ``record.span_id`` onto every log
    record from the active context. Idempotent; wraps (never replaces)
    whatever factory is installed, and leaves a trace id that factory
    stamped when this context has none (a process that also runs another
    tracer, the reference's among them, keeps that tracer's ids)."""
    global _factory_installed
    if _factory_installed:
        return
    _factory_installed = True
    previous = logging.getLogRecordFactory()

    def factory(*args, **kwargs):
        record = previous(*args, **kwargs)
        trace_id = _trace_id.get()
        if trace_id or not getattr(record, "trace_id", ""):
            record.trace_id = trace_id
            record.span_id = _span_id.get()
        return record

    logging.setLogRecordFactory(factory)
