"""Circuit breaker: closed -> open -> half-open -> closed, tripped by the
failure ratio of a rolling window, recovered by one probe (the port's copy
of ``gordo_components_tpu/resilience/breaker.py``).

The client fires machine x chunk requests per ``predict``; against a dead
endpoint each would pay a full connect or read timeout. With a breaker the
first few failures trip the circuit, every later call fails at once until
the recovery window has passed, and then ONE probe tests the endpoint
(half-open); its outcome closes or reopens the circuit. ``allow()`` before
the guarded call, ``record(ok)`` after; the clock is injectable, so tests
advance time instead of sleeping. Transitions count into
``gordo_resilience_breaker_*`` on the port's registry and land in the
control ledger (actor ``breaker``) after the breaker's lock is released.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

from ..analysis import lockcheck
from ..observability import ledger as control_ledger
from ..observability.registry import REGISTRY

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# gauge encoding (dashboards alert on == 1)
_STATE_VALUE = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}

_M_TRANSITIONS = REGISTRY.counter(
    "gordo_resilience_breaker_transitions_total",
    "Circuit-breaker state transitions, by breaker name and new state",
    labels=("name", "to"),
)
_M_STATE = REGISTRY.gauge(
    "gordo_resilience_breaker_state",
    "Current breaker state (0 closed, 1 open, 2 half-open)",
    labels=("name",),
)
_M_SHORT_CIRCUITS = REGISTRY.counter(
    "gordo_resilience_breaker_short_circuits_total",
    "Calls refused instantly because the breaker was open",
    labels=("name",),
)


class CircuitOpen(Exception):
    """The circuit is open; the call was refused without being attempted.
    ``retry_after`` is the seconds until the next half-open probe."""

    def __init__(self, name: str, retry_after: float):
        super().__init__(
            f"circuit {name!r} is open; retry in {retry_after:.1f}s"
        )
        self.retry_after = max(0.0, retry_after)


class CircuitBreaker:
    """``allow()`` before the guarded call, ``record(ok)`` after.

    Trips open when, among the last ``window`` outcomes (with at least
    ``min_calls`` seen), the failure ratio reaches ``failure_ratio``.
    After ``recovery_time`` seconds open, ONE caller gets a half-open
    probe; its success closes the circuit (history cleared), its failure
    re-opens it for another ``recovery_time``.
    """

    def __init__(
        self,
        name: str,
        failure_ratio: float = 0.5,
        window: int = 10,
        min_calls: int = 3,
        recovery_time: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.name = name
        self.failure_ratio = failure_ratio
        self.window = max(1, int(window))
        self.min_calls = max(1, int(min_calls))
        self.recovery_time = recovery_time
        self._clock = clock
        self._lock = lockcheck.named_lock("resilience.breaker")
        self._state = CLOSED
        self._outcomes: list = []  # rolling 1/0 window, newest last
        self._opened_at = 0.0
        self._probe_in_flight = False
        self._probe_started = 0.0
        # transitions noted under the breaker's lock and written to the
        # control ledger only after its release (an fsync under a hot lock
        # stalls traffic): (from, to) pairs, oldest first
        self._pending_events: list = []
        _M_STATE.labels(name).set(_STATE_VALUE[CLOSED])

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, to: str) -> None:
        # caller holds self._lock
        if to == self._state:
            return
        self._pending_events.append((self._state, to))
        self._state = to
        _M_TRANSITIONS.labels(self.name, to).inc()
        _M_STATE.labels(self.name).set(_STATE_VALUE[to])

    def _drain_events(self) -> None:
        """Write the noted transitions to the control ledger, outside the
        breaker's lock."""
        with self._lock:
            if not self._pending_events:
                return
            pending, self._pending_events = self._pending_events, []
        for src, dst in pending:
            control_ledger.emit(
                actor="breaker",
                action=(
                    "breaker-open" if dst == OPEN
                    else "breaker-close" if dst == CLOSED
                    else "breaker-probe"
                ),
                target=self.name, before=src, after=dst,
            )

    def allow(self) -> bool:
        """True when the caller may attempt the guarded call (and MUST then
        ``record`` its outcome). False = short-circuit: fail fast."""
        allowed = self._allow()
        self._drain_events()
        return allowed

    def _allow(self) -> bool:
        with self._lock:
            if self._state == CLOSED:
                return True
            now = self._clock()
            if self._state == OPEN:
                if now - self._opened_at < self.recovery_time:
                    _M_SHORT_CIRCUITS.labels(self.name).inc()
                    return False
                self._transition(HALF_OPEN)
                self._probe_in_flight = True
                self._probe_started = now
                return True
            # HALF_OPEN: exactly one probe at a time; everyone else waits.
            # A probe whose caller died between allow() and record()
            # (cancelled task, unexpected exception) would otherwise wedge
            # the breaker open FOREVER — reclaim the slot after a full
            # recovery window of silence.
            if self._probe_in_flight:
                if now - self._probe_started < self.recovery_time:
                    _M_SHORT_CIRCUITS.labels(self.name).inc()
                    return False
            self._probe_in_flight = True
            self._probe_started = now
            return True

    def retry_after(self) -> float:
        """Seconds until the next half-open probe would be allowed."""
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(
                0.0, self.recovery_time - (self._clock() - self._opened_at)
            )

    def guard(self) -> None:
        """``allow()`` or raise :class:`CircuitOpen` — the exception-style
        entry point for call sites that propagate errors upward."""
        if not self.allow():
            raise CircuitOpen(self.name, self.retry_after())

    def record(self, ok: bool) -> None:
        self._record(ok)
        self._drain_events()

    def _record(self, ok: bool) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_in_flight = False
                if ok:
                    # the probe proved the endpoint back: clean slate
                    self._outcomes.clear()
                    self._transition(CLOSED)
                else:
                    self._opened_at = self._clock()
                    self._transition(OPEN)
                return
            self._outcomes.append(1 if ok else 0)
            if len(self._outcomes) > self.window:
                del self._outcomes[: -self.window]
            if (
                self._state == CLOSED
                and len(self._outcomes) >= self.min_calls
            ):
                failures = self._outcomes.count(0)
                if failures / len(self._outcomes) >= self.failure_ratio:
                    self._opened_at = self._clock()
                    self._transition(OPEN)


class BreakerBoard:
    """Get-or-create breakers keyed by name — one per downstream endpoint,
    shared across a component's call sites (all of a client's chunk
    fetches to one base URL share one circuit)."""

    def __init__(self, **defaults):
        self._defaults = defaults
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._board_lock = lockcheck.named_lock("resilience.breaker_board")

    def get(self, name: str, **overrides) -> CircuitBreaker:
        with self._board_lock:
            breaker = self._breakers.get(name)
            if breaker is None:
                kwargs = dict(self._defaults)
                kwargs.update(overrides)
                breaker = self._breakers[name] = CircuitBreaker(
                    name, **kwargs
                )
            return breaker

    def states(self) -> Dict[str, str]:
        with self._board_lock:
            return {
                name: breaker.state
                for name, breaker in sorted(self._breakers.items())
            }

    def forget(self, name: str) -> None:
        """Drop a breaker whose downstream no longer exists, so status
        views stop reporting it. A later ``get`` of the name mints a fresh
        closed circuit."""
        with self._board_lock:
            self._breakers.pop(name, None)
