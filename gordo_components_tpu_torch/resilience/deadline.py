"""Deadline propagation: ``X-Gordo-Deadline`` header → context variable →
checks (the port's copy of ``gordo_components_tpu/resilience/deadline.py``).

The client sends its REMAINING budget in seconds (relative, so no clock
sync across hosts is assumed); the server binds it to the request's
context as an absolute monotonic deadline, and the expensive boundaries
(the admission queue, the engine's dispatch) check it before starting:
expired work answers 504 at once instead of taking a thread and a device
slot.
"""

from __future__ import annotations

import contextlib
import math
import time
from contextvars import ContextVar
from typing import Iterator, Optional

from ..observability.registry import REGISTRY

DEADLINE_HEADER = "X-Gordo-Deadline"

# absolute time.monotonic() deadline; 0.0 = no deadline bound
_deadline: ContextVar[float] = ContextVar("gordo_deadline", default=0.0)

_M_EXPIRED = REGISTRY.counter(
    "gordo_resilience_deadline_expired_total",
    "Work refused because the request's deadline had already passed, "
    "by the boundary that caught it",
    labels=("where",),
)


class DeadlineExceeded(Exception):
    """The bound deadline passed before the work; the HTTP layer answers
    504."""


def parse_header(value: Optional[str]) -> Optional[float]:
    """Header value → remaining seconds, or None when absent or garbage
    (a bad proxy header forfeits deadline cover; it never fails scoring).
    Negative budgets are already expired; values cap at a day."""
    if not value:
        return None
    try:
        seconds = float(value)
    except (TypeError, ValueError):
        return None
    if not math.isfinite(seconds):
        return None
    return max(0.0, min(seconds, 86400.0))


def set_deadline(seconds: float):
    """Bind ``now + seconds`` as the context deadline; returns the reset
    token."""
    return _deadline.set(time.monotonic() + seconds)


def reset(token) -> None:
    _deadline.reset(token)


def remaining() -> Optional[float]:
    """Seconds left (may be negative), or None when no deadline is bound."""
    bound = _deadline.get()
    if not bound:
        return None
    return bound - time.monotonic()


def check(where: str) -> None:
    """Raise :class:`DeadlineExceeded` if the bound deadline has passed; a
    no-op without one (warmup, direct engine calls)."""
    left = remaining()
    if left is not None and left <= 0.0:
        _M_EXPIRED.labels(where).inc()
        raise DeadlineExceeded(f"deadline exceeded {-left:.3f}s ago (checked at {where})")


@contextlib.contextmanager
def deadline_scope(seconds: Optional[float]) -> Iterator[None]:
    """Bind a deadline for the duration of the block (no-op on None)."""
    if seconds is None:
        yield
        return
    token = set_deadline(seconds)
    try:
        yield
    finally:
        _deadline.reset(token)
