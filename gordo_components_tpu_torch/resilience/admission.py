"""Admission control: a bounded gate that sheds load early (the port's copy
of ``gordo_components_tpu/resilience/admission.py``, for the one default
priority class of ``resilience/qos.py:381-400``; tenants, quotas and the
other classes wait for QoS).

Without it every request the HTTP server accepts parks a thread on the
engine: under a spike the server piles up threads, memory and latency. The
gate bounds the concurrently scoring requests (``max_inflight``) and the
waiters behind them; beyond that it sheds at once with
:class:`AdmissionRejected` (HTTP 503 + ``Retry-After``). The default class
("standard") admits against the full in-flight bound and half of
``max_queue`` (``_QUEUE_SHARE``), exactly as the reference admits a
request of its default tenant. ``Retry-After`` derives from the measured
release rate, and a waiter never queues past its request's deadline.
``close``/``drain`` serve a graceful shutdown.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Optional

from ..observability.registry import REGISTRY
from . import deadline

# the default class's watermarks (reference resilience/qos.py _CLASS_SHARE
# and _QUEUE_SHARE for "standard")
_INFLIGHT_SHARE = 1.0
_QUEUE_SHARE = 0.5

_M_INFLIGHT = REGISTRY.gauge(
    "gordo_resilience_inflight",
    "Requests currently admitted and scoring (admission gate occupancy)",
)
_M_QUEUE_DEPTH = REGISTRY.gauge(
    "gordo_resilience_queue_depth",
    "Requests waiting at the admission gate for an in-flight slot",
)
_M_ADMISSION = REGISTRY.counter(
    "gordo_resilience_admission_total",
    "Admission-gate decisions (admitted / shed_queue_full / shed_timeout "
    "/ shed_deadline / shed_closed)",
    labels=("outcome",),
)

# stamped on everything a draining server answers
DRAINING_HEADER = "X-Gordo-Draining"


class AdmissionRejected(Exception):
    """The gate shed this request; the HTTP layer answers 503 with
    ``Retry-After: retry_after``."""

    def __init__(self, reason: str, retry_after: float):
        super().__init__(reason)
        self.retry_after = retry_after


class AdmissionController:
    """``with gate.admit(): score()``; raises :class:`AdmissionRejected`
    when saturated. ``queue_timeout``: how long a waiter holds its thread
    before shedding anyway; ``retry_after``: the hint before a release rate
    has been measured."""

    def __init__(self, max_inflight: int = 64, max_queue: int = 32,
                 queue_timeout: float = 1.0, retry_after: float = 1.0,
                 clock=time.monotonic):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.max_inflight = max_inflight
        self.max_queue = max(0, int(max_queue))
        self.queue_timeout = queue_timeout
        self.retry_after = retry_after
        self._clock = clock
        self._cond = threading.Condition()
        self._inflight = 0
        self._waiting = 0
        self._closed: Optional[str] = None
        # release timestamps over a bounded ring: the measured drain rate
        self._releases: deque = deque(maxlen=128)

    @property
    def inflight_limit(self) -> int:
        return max(0, int(math.floor(self.max_inflight * _INFLIGHT_SHARE)))

    @property
    def queue_limit(self) -> int:
        return max(0, int(math.floor(self.max_queue * _QUEUE_SHARE)))

    def stats(self) -> dict:
        with self._cond:
            rate = self._drain_rate_locked()
            return {
                "inflight": self._inflight,
                "queue_depth": self._waiting,
                "max_inflight": self.max_inflight,
                "max_queue": self.max_queue,
                "closed": self._closed,
                "inflight_limit": self.inflight_limit,
                "queue_limit": self.queue_limit,
                "drain_rate_rps": round(rate, 3) if rate else None,
            }

    def _drain_rate_locked(self) -> Optional[float]:
        """Slots per second the gate has freed over the release ring; None
        before two releases."""
        if len(self._releases) < 2:
            return None
        span = self._releases[-1] - self._releases[0]
        if span <= 0:
            return None
        return (len(self._releases) - 1) / span

    def _retry_hint_locked(self) -> float:
        """How long, at the measured drain rate, until enough slots free
        for this request to clear the queue ahead of it; clamped to [0.1,
        30] s."""
        rate = self._drain_rate_locked()
        if not rate:
            return self.retry_after
        needed = max(1, self._inflight + self._waiting - self.inflight_limit + 1)
        return min(30.0, max(0.1, needed / rate))

    # -- graceful shutdown ---------------------------------------------------
    @property
    def closed(self) -> Optional[str]:
        """The close reason while the gate is draining, else None."""
        with self._cond:
            return self._closed

    def close(self, reason: str = "shutting down") -> None:
        """Stop admitting (every later ``admit()`` sheds with ``reason``)
        while admitted requests finish; queued waiters shed now."""
        with self._cond:
            self._closed = reason
            self._cond.notify_all()

    def drain(self, timeout: float) -> bool:
        """Wait until no admitted request remains (True) or ``timeout``
        passed (False)."""
        end = time.monotonic() + timeout
        with self._cond:
            while self._inflight > 0:
                left = end - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(timeout=left)
        return True

    # -- gate ----------------------------------------------------------------
    def admit(self) -> "_Admission":
        """Take an in-flight slot, or queue for one (bounded by the queue
        limit, ``queue_timeout`` and the request's deadline), or raise
        :class:`AdmissionRejected`."""
        with self._cond:
            if self._closed is not None:
                _M_ADMISSION.labels("shed_closed").inc()
                raise AdmissionRejected(self._closed, self.retry_after)
            limit = self.inflight_limit
            if self._inflight < limit:
                return self._take_locked()
            if self._waiting >= self.queue_limit:
                _M_ADMISSION.labels("shed_queue_full").inc()
                raise AdmissionRejected(
                    f"saturated: {self._inflight} in flight, {self._waiting} queued",
                    self._retry_hint_locked(),
                )
            budget = self.queue_timeout
            left = deadline.remaining()
            if left is not None:
                if left <= 0:
                    _M_ADMISSION.labels("shed_deadline").inc()
                    raise AdmissionRejected("deadline expired while queueing",
                                            self._retry_hint_locked())
                budget = min(budget, left)
            self._waiting += 1
            _M_QUEUE_DEPTH.set(self._waiting)
            try:
                end = time.monotonic() + budget
                while self._inflight >= limit:
                    if self._closed is not None:  # close() woke us
                        _M_ADMISSION.labels("shed_closed").inc()
                        raise AdmissionRejected(self._closed, self.retry_after)
                    left = end - time.monotonic()
                    if left <= 0:
                        _M_ADMISSION.labels("shed_timeout").inc()
                        raise AdmissionRejected(
                            f"queued {budget:.2f}s without a slot freeing",
                            self._retry_hint_locked(),
                        )
                    self._cond.wait(timeout=left)
                return self._take_locked()
            finally:
                self._waiting -= 1
                _M_QUEUE_DEPTH.set(self._waiting)

    def _take_locked(self) -> "_Admission":
        self._inflight += 1
        _M_INFLIGHT.set(self._inflight)
        _M_ADMISSION.labels("admitted").inc()
        return _Admission(self)

    def _release(self) -> None:
        with self._cond:
            self._inflight -= 1
            _M_INFLIGHT.set(self._inflight)
            self._releases.append(self._clock())
            # queue waiters and a drain() caller may both be parked here
            self._cond.notify_all()


class _Admission:
    """Context manager releasing the slot exactly once."""

    __slots__ = ("_gate", "_released")

    def __init__(self, gate: AdmissionController):
        self._gate = gate
        self._released = False

    def __enter__(self) -> "_Admission":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._gate._release()
