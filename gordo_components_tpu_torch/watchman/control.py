"""Watchman promoted from prober to control plane (the port's copy of
``gordo_components_tpu/watchman/control.py``; probes ride the port's
``utils.http.Session`` in place of a pooled ``requests.Session``).

The original watchman (server.py in this package) OBSERVES a fleet:
``GET /`` polls every machine's healthz and reports. This module closes
the loop for the horizontal serving tier: the same probe machinery —
per-target circuit breakers, the quarantine ledger — now DRIVES repair.
A worker whose process died, or whose probes tripped its breaker
(unreachable / hung, not merely degraded), is ejected: quarantined,
terminated, and respawned through the supervisor; its recovery is
probe-verified like any quarantined machine's.

Probe scheduling carries ±``jitter_frac`` jitter (default ±10%): a large
fleet whose control planes all woke on the same tick would thundering-
herd every worker's ``/healthz`` simultaneously — and, worse, eject in
lockstep. Jitter decorrelates the fleet for free.

Health vocabulary (what the router reads per worker):

- ``ok`` — process alive, last probe answered 200 ready.
- ``degraded`` — answered, but named sick machines (still routable).
- ``draining`` — answered 503 with the draining marker: the worker is
  shutting down gracefully; route AROUND it, do not eject it (its exit
  is deliberate — a rolling restart in progress).
- ``unreachable`` — probe failed at transport level; breaker counts it.
- ``dead`` — the process itself is gone.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from ..analysis import lockcheck
from ..observability.registry import REGISTRY
from ..resilience import faults
from ..resilience.admission import DRAINING_HEADER
from ..resilience.breaker import BreakerBoard
from ..resilience.quarantine import Quarantine
from ..utils import http

logger = logging.getLogger(__name__)

__all__ = ["ControlPlane", "DRAINING_HEADER", "jittered_interval"]

_M_WORKER_PROBES = REGISTRY.counter(
    "gordo_watchman_worker_probes_total",
    "Control-plane worker health probes, by outcome (ok / degraded / "
    "draining / unhealthy / unreachable / dead / short_circuit)",
    labels=("outcome",),
)
_M_EJECTIONS = REGISTRY.counter(
    "gordo_watchman_worker_ejections_total",
    "Workers ejected (terminated + respawned) by the control plane, by "
    "cause (dead = process exited, unreachable = breaker tripped)",
    labels=("worker", "cause"),
)


def jittered_interval(
    interval: float,
    frac: float = 0.1,
    rng: Callable[[float, float], float] = random.uniform,
) -> float:
    """``interval`` ± ``frac`` (uniform): probe ticks across a fleet of
    control planes (and across this one's successive ticks) decorrelate
    instead of synchronizing into a thundering herd. ``rng`` is
    injectable so tests assert the bounds instead of sampling."""
    if interval <= 0:
        return 0.0
    return interval * (1.0 + frac * rng(-1.0, 1.0))


class ControlPlane:
    """Probe workers; eject and respawn the sick ones.

    ``supervisor``: a :class:`router.workers.WorkerSupervisor` (anything
    with ``specs / workers() / alive() / respawn()``). ``respawn``:
    False turns repair off (observe-only — the original watchman
    behavior, useful in tests and for a read-only status plane).

    The breaker board and quarantine ledger are PUBLIC: the router
    shares them, so a worker that probes unreachable is also skipped by
    routing within one probe cycle, and a routing failure burst
    contributes to the same circuit the prober reads.
    """

    def __init__(
        self,
        supervisor,
        probe_timeout: float = 3.0,
        breaker_recovery: float = 10.0,
        quarantine_cooldown: float = 10.0,
        respawn: bool = True,
        jitter_frac: float = 0.1,
        boot_grace: float = 30.0,
        clock=time.monotonic,
        history: int = 64,
    ):
        self.supervisor = supervisor
        self.probe_timeout = probe_timeout
        self.respawn = respawn
        self.jitter_frac = jitter_frac
        self.boot_grace = boot_grace
        self._clock = clock
        # respawn timestamps: a worker younger than boot_grace whose
        # probes fail is BOOTING, not sick — without this, probe failures
        # during a respawned worker's torch-import window would trip its
        # breaker and eject it again, a respawn storm that never converges
        self._spawned_at: Dict[str, float] = {}
        # per-WORKER circuits: only transport-level unreachability counts,
        # mirroring the watchman prober's host-circuit semantics
        self.breakers = BreakerBoard(
            recovery_time=breaker_recovery, clock=clock
        )
        self.quarantine = Quarantine(
            cooldown=quarantine_cooldown, clock=clock
        )
        self._lock = lockcheck.named_lock("watchman.control")
        self._last: Dict[str, Dict[str, Any]] = {}
        self._events: deque = deque(maxlen=history)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # pooled connections for the probe loop — the control plane's
        # steady-state hottest HTTP caller must not pay a TCP handshake
        # per worker per tick (and warm sockets keep the measured
        # /healthz latency honest)
        self._session = None

    def _http(self) -> http.Session:
        if self._session is None:
            self._session = http.Session()
        return self._session

    # -- probing -------------------------------------------------------------
    def _probe_worker(self, name: str, spec) -> Dict[str, Any]:
        worker = self.supervisor.worker(name)
        if worker is None or not worker.alive():
            return {"state": "dead", "error": "process not running"}
        breaker = self.breakers.get(name)
        if not breaker.allow():
            _M_WORKER_PROBES.labels("short_circuit").inc()
            return {
                "state": "unreachable",
                "error": (
                    f"circuit open; next probe in "
                    f"{breaker.retry_after():.0f}s"
                ),
                "short_circuit": True,
            }
        started = time.perf_counter()
        try:
            # chaos seam: `probe:<worker>:error` stands in for a wedged
            # worker without wedging one
            faults.inject("probe", name)
            response = self._http().get(
                f"{spec.base_url}/healthz", timeout=self.probe_timeout
            )
        except (http.TransportError, faults.FaultInjected) as exc:
            with self._lock:
                spawned = self._spawned_at.get(name)
            if (
                spawned is not None
                and self._clock() - spawned < self.boot_grace
            ):
                # booting, not sick: don't feed the breaker, don't eject
                _M_WORKER_PROBES.labels("booting").inc()
                return {"state": "booting", "error": repr(exc)}
            breaker.record(False)
            _M_WORKER_PROBES.labels("unreachable").inc()
            return {
                "state": "unreachable",
                "error": repr(exc),
                "latency_ms": (time.perf_counter() - started) * 1000,
            }
        breaker.record(True)
        latency_ms = (time.perf_counter() - started) * 1000
        body: Dict[str, Any] = {}
        try:
            parsed = response.json()
            if isinstance(parsed, dict):
                body = parsed
        except ValueError:
            pass
        if response.headers.get(DRAINING_HEADER) or (
            body.get("status") == "draining"
        ):
            # deliberate shutdown in progress (rolling restart): route
            # around it, never eject it — ejecting would kill the very
            # drain that makes the restart zero-drop
            _M_WORKER_PROBES.labels("draining").inc()
            return {"state": "draining", "latency_ms": latency_ms}
        if response.status_code != 200 or not body.get("ready", True):
            _M_WORKER_PROBES.labels("unhealthy").inc()
            return {
                "state": "unhealthy",
                "error": f"HTTP {response.status_code}",
                "latency_ms": latency_ms,
            }
        state = "degraded" if body.get("status") == "degraded" else "ok"
        _M_WORKER_PROBES.labels(state).inc()
        return {
            "state": state,
            "latency_ms": latency_ms,
            "quarantined": sorted(body.get("quarantined") or {}),
            "generations": (body.get("store") or {}).get("generations"),
            "worker_id": body.get("worker_id"),
        }

    def probe_once(self) -> Dict[str, Dict[str, Any]]:
        """One probe sweep over every worker slot; drives eject/respawn.
        Returns the per-worker result map (also kept for ``status()``)."""
        # first sight of a slot stamps its spawn time: the INITIAL boot
        # deserves the same grace a respawn gets — without this, a
        # worker still importing torch when probing begins would be
        # ejected mid-boot (the trade: a worker already wedged when the
        # control plane starts waits out one boot_grace before eject)
        now = self._clock()
        with self._lock:
            for name in self.supervisor.specs:
                self._spawned_at.setdefault(name, now)
        results: Dict[str, Dict[str, Any]] = {}
        for name, spec in sorted(self.supervisor.specs.items()):
            result = self._probe_worker(name, spec)
            if name not in self.supervisor.specs:
                # retired while this sweep probed it (elastic scale-down):
                # its exit is deliberate, and the slot has nothing to respawn
                continue
            result["worker"] = name
            result["base_url"] = spec.base_url
            results[name] = result
            state = result["state"]
            if state == "dead":
                self._eject(name, "dead", result.get("error", ""))
            elif (
                state == "unreachable"
                and self.breakers.get(name).state != "closed"
                and not result.get("short_circuit")
            ):
                # the probe that TRIPPED (or re-opened) the circuit: the
                # worker is alive but not answering — eject it. Short-
                # circuited sweeps skip this: the previous eject already
                # acted, and the respawned worker deserves its boot time.
                self._eject(name, "unreachable", result.get("error", ""))
            elif state in ("ok", "degraded"):
                # boot complete: drop the grace so a LATER wedge ejects
                # promptly instead of waiting out the rest of the window
                with self._lock:
                    self._spawned_at.pop(name, None)
                if self.quarantine.recover(name):
                    self._note_event("recovered", name, "")
        with self._lock:
            self._last = results
        return results

    def _eject(self, name: str, cause: str, error: str) -> None:
        already = self.quarantine.is_quarantined(name)
        self.quarantine.quarantine(name, error or cause, "probe")
        if not already:
            _M_EJECTIONS.labels(name, cause).inc()
            self._note_event("ejected", name, f"{cause}: {error}")
        if self.respawn:
            try:
                self.supervisor.respawn(name, cause=cause)
                with self._lock:
                    self._spawned_at[name] = self._clock()
                self._note_event("respawned", name, cause)
            except Exception:
                logger.exception("Respawn of worker %s failed", name)
                self._note_event("respawn_failed", name, cause)

    def _note_event(self, event: str, worker: str, detail: str) -> None:
        with self._lock:
            self._events.append(
                {
                    "at": time.strftime("%Y-%m-%d %H:%M:%S%z"),
                    "event": event,
                    "worker": worker,
                    "detail": detail,
                }
            )
        logger.info("Control plane: %s %s (%s)", event, worker, detail)

    # -- router-facing health view -------------------------------------------
    def routable(self, name: str) -> bool:
        """May the router send traffic to this worker right now? Alive
        process, circuit not open, not mid-drain, not quarantined. A
        worker with NO probe history yet is routable (boot grace — the
        router's own forward failures will trip the breaker if not)."""
        if not self.supervisor.alive(name):
            return False
        if self.quarantine.is_quarantined(name):
            return False
        if self.breakers.get(name).state == "open":
            return False
        with self._lock:
            last = self._last.get(name)
        return last is None or last["state"] != "draining"

    def last_probe(self, name: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            result = self._last.get(name)
            return dict(result) if result else None

    def forget(self, name: str) -> None:
        """Drop all health state for a worker that LEFT the slot table
        (elastic retire, §20): probe history, spawn grace, quarantine
        entry, and its circuit — a retired worker must not haunt status
        views, and a future worker reusing the name starts clean."""
        with self._lock:
            self._last.pop(name, None)
            self._spawned_at.pop(name, None)
        self.quarantine.recover(name)
        forget = getattr(self.breakers, "forget", None)
        if callable(forget):
            forget(name)

    def status(self) -> Dict[str, Any]:
        with self._lock:
            last = {name: dict(r) for name, r in self._last.items()}
            events = list(self._events)
        return {
            "workers": last,
            "routable": {
                name: self.routable(name)
                for name in sorted(self.supervisor.specs)
            },
            "circuits": self.breakers.states(),
            "quarantined": self.quarantine.quarantined(),
            "respawns": self.supervisor.respawn_counts(),
            "events": events[-20:],
        }

    # -- scheduling ----------------------------------------------------------
    def start(self, interval: float = 2.0) -> None:
        """Run the probe loop on a daemon thread, each tick separated by
        a JITTERED interval (±``jitter_frac``)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.is_set():
                try:
                    self.probe_once()
                except Exception:
                    logger.exception("Control-plane probe sweep failed")
                self._stop.wait(
                    jittered_interval(interval, self.jitter_frac)
                )

        self._thread = threading.Thread(
            target=loop, name="gordo-control-plane", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._session is not None:
            self._session.close()
            self._session = None  # a restarted plane rebuilds its pool
