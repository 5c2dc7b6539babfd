"""Admission control: a bounded, class-aware gate that sheds load early
(the port's copy of ``gordo_components_tpu/resilience/admission.py``).

Without it every request the HTTP server accepts parks a thread on the
engine: under a spike the server piles up threads, memory and latency. The
gate bounds the concurrently scoring requests (``max_inflight``) and the
waiters behind them (``max_queue``); beyond that it sheds at once.

The gate is class-aware: each priority class admits against its own
watermark (``qos.class_limit``, ``qos.queue_limit``), so under pressure
bulk stops first and interactive last, and a freed slot goes to the
highest class waiting. Two rejections:

- **quota exhausted** (:class:`QuotaExceeded`, HTTP 429): this tenant spent
  its token bucket; ``Retry-After`` is the bucket's refill time;
- **overloaded** (:class:`AdmissionRejected`, HTTP 503): the gate is full
  for this request's class; ``Retry-After`` derives from the measured
  release rate.

A waiter never queues past its request's deadline. ``close``/``drain``
serve a graceful shutdown. The autopilot's two admission actuators resize
the gate live: ``set_max_inflight`` (journaled by the autopilot, not here)
and ``set_shed_level``, which moves the shed ladder (bulk only) and records
the move in the control ledger.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional

from ..analysis import lockcheck
from ..observability import ledger as control_ledger
from ..observability.registry import REGISTRY
from . import deadline, qos

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
    "/ shed_deadline)",
    labels=("outcome",),
)


# response header a draining server stamps on everything it answers: the
# router re-routes marked sheds to a live worker (and never ejects the
# drainer), and clients retry them immediately instead of backing off —
# the restart window is deliberate and short
DRAINING_HEADER = "X-Gordo-Draining"


class AdmissionRejected(Exception):
    """The gate shed this request (overload); HTTP layers translate to
    503 with ``Retry-After: retry_after``."""

    def __init__(self, reason: str, retry_after: float):
        super().__init__(reason)
        self.retry_after = retry_after


class QuotaExceeded(AdmissionRejected):
    """THIS tenant's token bucket is spent — the fleet is not overloaded.
    HTTP layers translate to 429 (not 503) so clients can tell "slow
    down" from "the service is hurting"; the transport breaker must NOT
    trip on it."""

    def __init__(self, reason: str, retry_after: float,
                 tenant: str = qos.DEFAULT_TENANT):
        super().__init__(reason, retry_after)
        self.tenant = tenant


class AdmissionController:
    """``with gate.admit(): score()`` — raises :class:`AdmissionRejected`
    when saturated.

    ``max_inflight``: concurrent admitted requests (size to the engine's
    useful parallelism — roughly max_batch per bucket, not the HTTP server's
    thread count). ``max_queue``: waiters allowed behind a full gate
    (micro-burst absorption). ``queue_timeout``: how long a waiter holds
    its thread before shedding anyway. ``retry_after``: the backoff hint
    shed responses FALL BACK to before the gate has measured a drain
    rate. ``tenants``: the quota table (None = no quotas, classes
    still honored via the request contextvar).
    """

    def __init__(
        self,
        max_inflight: int = 64,
        max_queue: int = 32,
        queue_timeout: float = 1.0,
        retry_after: float = 1.0,
        tenants: Optional[qos.TenantTable] = None,
        clock=time.monotonic,
    ):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.max_inflight = max_inflight
        self.max_queue = max(0, int(max_queue))
        self.queue_timeout = queue_timeout
        self.retry_after = retry_after
        self.tenants = tenants
        self._clock = clock
        self._cond = lockcheck.named_condition("server.admission")
        self._inflight = 0
        self._waiting = 0
        self._waiting_by: Dict[str, int] = {k: 0 for k in qos.CLASSES}
        self._closed: Optional[str] = None
        self._shed_level = 0
        # release timestamps (monotonic) over a bounded ring: the
        # measured drain rate honest Retry-After hints derive from
        self._releases: deque = deque(maxlen=128)
        self._class_sheds: Dict[str, int] = {k: 0 for k in qos.CLASSES}

    # -- stats ---------------------------------------------------------------
    @property
    def inflight(self) -> int:
        with self._cond:
            return self._inflight

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return self._waiting

    @property
    def shed_level(self) -> int:
        with self._cond:
            return self._shed_level

    @property
    def inflight_limit(self) -> int:
        """The default class's in-flight watermark at the current rung."""
        with self._cond:
            return qos.class_limit(self.max_inflight, qos.DEFAULT_CLASS, self._shed_level)

    @property
    def queue_limit(self) -> int:
        """The default class's share of the waiter queue."""
        return qos.queue_limit(self.max_queue, qos.DEFAULT_CLASS)

    def stats(self) -> dict:
        with self._cond:
            rate = self._drain_rate_locked()
            return {
                "inflight": self._inflight,
                "queue_depth": self._waiting,
                "max_inflight": self.max_inflight,
                "max_queue": self.max_queue,
                "closed": self._closed,
                "shed_level": self._shed_level,
                "class_limits": {
                    klass: qos.class_limit(
                        self.max_inflight, klass, self._shed_level
                    )
                    for klass in qos.CLASSES
                },
                "class_sheds": dict(self._class_sheds),
                "queue_by_class": dict(self._waiting_by),
                "drain_rate_rps": round(rate, 3) if rate else None,
            }

    def _higher_waiting_locked(self, klass: str) -> bool:
        """True when a strictly-higher-class waiter is parked at the
        gate. Freed slots hand off by class, not by which thread wins
        the lock race: a lower-class request — queued OR newly arriving
        on the fast path — must not take a slot out from under a parked
        interactive waiter, or the class ordering the watermarks promise
        dissolves into scheduler luck under saturation."""
        rank = qos.CLASS_RANK.get(klass, qos.CLASS_RANK[qos.DEFAULT_CLASS])
        for other, other_rank in qos.CLASS_RANK.items():
            if other_rank < rank and self._waiting_by.get(other, 0) > 0:
                return True
        return False

    # -- measured drain rate -------------------------------------------------
    def _drain_rate_locked(self) -> Optional[float]:
        """Slots/second the gate has actually been freeing, over the
        bounded release ring. None until two releases have been seen —
        callers fall back to the static ``retry_after`` hint."""
        if len(self._releases) < 2:
            return None
        span = self._releases[-1] - self._releases[0]
        if span <= 0:
            return None
        return (len(self._releases) - 1) / span

    def _retry_hint_locked(self, limit: int) -> float:
        """Honest Retry-After for an overload shed: how long, at the
        measured drain rate, until enough slots free for this request to
        clear both the queue ahead of it and the class watermark. Clamped
        to [0.1, 30] so a momentarily tiny rate cannot tell a client to
        go away for an hour."""
        rate = self._drain_rate_locked()
        if not rate:
            return self.retry_after
        needed = max(1, self._inflight + self._waiting - max(0, limit) + 1)
        return min(30.0, max(0.1, needed / rate))

    # -- live tuning ---------------------------------------------------------
    def set_shed_level(self, level: int) -> int:
        """The autopilot's shed actuator: each step tightens the
        BULK class's watermark by 1/``qos.SHED_MAX`` of its share —
        interactive and standard admission are never touched by the
        ladder. Raising wakes waiters so newly-over-limit bulk waiters
        shed now; lowering lets queued bulk work re-qualify. Returns the
        applied (clamped) value."""
        level = max(0, min(qos.SHED_MAX, int(level)))
        with self._cond:
            lockcheck.assert_guard("server.admission")
            previous = self._shed_level
            self._shed_level = level
            self._cond.notify_all()
        if level != previous:
            # emitted AFTER releasing the HOT admission lock (the
            # ledger fsyncs; a stall here would block every admit)
            control_ledger.emit(
                actor="qos", action="shed-level", target="bulk",
                before=previous, after=level,
            )
        return level

    def set_max_inflight(self, max_inflight: int) -> int:
        """Resize the gate live (the autopilot's admission actuator). A
        raise wakes queued waiters so the new slots are taken at once; a
        cut sheds no one already admitted: the gate admits again once
        occupancy drains below the new bound. Returns the applied value."""
        max_inflight = max(1, int(max_inflight))
        with self._cond:
            self.max_inflight = max_inflight
            self._cond.notify_all()
        return max_inflight

    # -- graceful shutdown ---------------------------------------------------
    @property
    def closed(self) -> Optional[str]:
        """The close reason when the gate is draining, else None."""
        with self._cond:
            return self._closed

    def close(self, reason: str = "shutting down") -> None:
        """Stop admitting NEW work (every later ``admit()`` sheds
        instantly with the reason) while in-flight requests keep their
        slots and finish — the first step of a graceful shutdown. Queued
        waiters are woken so they shed now instead of burning their full
        queue timeout against a gate that can never admit them."""
        with self._cond:
            lockcheck.assert_guard("server.admission")
            self._closed = reason
            self._cond.notify_all()

    def drain(self, timeout: float) -> bool:
        """Wait until no admitted request remains in flight (True), or
        ``timeout`` elapsed first (False). Meaningful after close()."""
        end = time.monotonic() + timeout
        with self._cond:
            while self._inflight > 0:
                left = end - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(timeout=left)
        return True

    # -- gate ----------------------------------------------------------------
    def admit(
        self, tenant: Optional[qos.TenantSpec] = None
    ) -> "_Admission":
        """Acquire an in-flight slot or raise :class:`AdmissionRejected`
        (:class:`QuotaExceeded` for a spent token bucket — the 429 case).

        The tenant comes from the argument or the request contextvar
        (``qos.current()``); bare requests fold into the default tenant.
        Quota is checked BEFORE the gate lock — the token-bucket table
        has its own lock (rank ``resilience.qos``) and the two are never
        nested. Then the class watermark applies: fast path when the
        class has a free slot, else join the bounded queue and wait up
        to ``queue_timeout`` (clipped to the request's remaining
        deadline — a waiter whose caller has given up must not keep
        holding a queue slot)."""
        spec = tenant if tenant is not None else qos.current()
        klass = spec.klass if spec is not None else qos.DEFAULT_CLASS
        if spec is not None and self.tenants is not None:
            allowed, wait = self.tenants.take(spec)
            if not allowed:
                _M_ADMISSION.labels("shed_quota").inc()
                raise QuotaExceeded(
                    f"tenant {spec.name} quota exhausted",
                    max(0.1, wait),
                    tenant=spec.name,
                )
        with self._cond:
            if self._closed is not None:
                _M_ADMISSION.labels("shed_closed").inc()
                raise AdmissionRejected(self._closed, self.retry_after)
            limit = qos.class_limit(
                self.max_inflight, klass, self._shed_level
            )
            if limit <= 0:
                # the shed ladder has squeezed this class to zero: shed
                # instantly, no queueing — the slot behind us belongs to
                # a class that is still being served
                self._note_shed_locked(klass, "shed_class")
                raise AdmissionRejected(
                    f"class {klass} shed at level {self._shed_level}",
                    self._retry_hint_locked(limit),
                )
            if self._inflight < limit and not self._higher_waiting_locked(
                klass
            ):
                lockcheck.assert_guard("server.admission")
                self._inflight += 1
                _M_INFLIGHT.set(self._inflight)
                _M_ADMISSION.labels("admitted").inc()
                return _Admission(self)
            if self._waiting >= qos.queue_limit(self.max_queue, klass):
                self._note_shed_locked(klass, "shed_queue_full")
                raise AdmissionRejected(
                    f"saturated: {self._inflight} in flight, "
                    f"{self._waiting} queued",
                    self._retry_hint_locked(limit),
                )
            budget: Optional[float] = self.queue_timeout
            left = deadline.remaining()
            if left is not None:
                if left <= 0:
                    self._note_shed_locked(klass, "shed_deadline")
                    raise AdmissionRejected(
                        "deadline expired while queueing",
                        self._retry_hint_locked(limit),
                    )
                budget = min(budget, left)
            self._waiting += 1
            self._waiting_by[klass] = self._waiting_by.get(klass, 0) + 1
            _M_QUEUE_DEPTH.set(self._waiting)
            try:
                end = time.monotonic() + budget
                while True:
                    # re-derive each wake-up: the shed level may have
                    # moved while we slept
                    limit = qos.class_limit(
                        self.max_inflight, klass, self._shed_level
                    )
                    if self._inflight < limit and \
                            not self._higher_waiting_locked(klass):
                        break
                    if self._closed is not None:  # close() woke us: shed
                        _M_ADMISSION.labels("shed_closed").inc()
                        raise AdmissionRejected(
                            self._closed, self.retry_after
                        )
                    if limit <= 0:
                        self._note_shed_locked(klass, "shed_class")
                        raise AdmissionRejected(
                            f"class {klass} shed at level "
                            f"{self._shed_level}",
                            self._retry_hint_locked(limit),
                        )
                    left = end - time.monotonic()
                    if left <= 0:
                        self._note_shed_locked(klass, "shed_timeout")
                        raise AdmissionRejected(
                            f"queued {budget:.2f}s without a slot freeing",
                            self._retry_hint_locked(limit),
                        )
                    self._cond.wait(timeout=left)
                self._inflight += 1
                _M_INFLIGHT.set(self._inflight)
                _M_ADMISSION.labels("admitted").inc()
                return _Admission(self)
            finally:
                self._waiting -= 1
                self._waiting_by[klass] -= 1
                _M_QUEUE_DEPTH.set(self._waiting)
                # a departing waiter may have been the blocker a
                # lower-class waiter was deferring to (priority handoff
                # checks _waiting_by, not just occupancy) — wake the
                # gate so deferred waiters re-check now instead of
                # sleeping until the next release or their timeout
                self._cond.notify_all()

    def _note_shed_locked(self, klass: str, outcome: str) -> None:
        _M_ADMISSION.labels(outcome).inc()
        self._class_sheds[klass] = self._class_sheds.get(klass, 0) + 1

    def _release(self) -> None:
        with self._cond:
            self._inflight -= 1
            _M_INFLIGHT.set(self._inflight)
            self._releases.append(self._clock())
            # notify_all, not notify: queue waiters AND a drain() caller
            # may both be parked here — a single wake-up could land on
            # the wrong one and strand the other past its timeout
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
