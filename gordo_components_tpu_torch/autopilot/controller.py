"""The autopilot's brain (the port's copy of
``gordo_components_tpu/autopilot/controller.py``): observation, policy,
actuation, journaled.

One :class:`Autopilot` per server tunes its own data plane. Evaluation is
scrape-driven like the SLO engine it reads: ``maybe_tick`` runs on
``/metrics`` and ``/autopilot`` reads, gated by a minimum interval; no
thread, and the clock is injectable end to end.

Safety, in order of authority:

1. **Hard kill switch**: ``GORDO_AUTOPILOT=0`` constructs no controller
   (``build_server_autopilot`` returns None; the endpoints answer
   ``hard_off``). Unset boots a DISABLED controller an operator can enable
   at runtime; ``1`` boots enabled.
2. **Runtime freeze**: ``disable()`` (``POST /autopilot/disable``) stops
   all adaptation at once while status stays readable; ``enable()``
   resumes.
3. **Hard bounds**: every actuator clamps to its ``min:max`` knob.
4. **Hysteresis and cooldown**: a direction must persist ``confirm``
   consecutive ticks, and an actuator rests ``cooldown`` seconds after
   each applied change.
5. **Oscillation guard**: a second direction flip within the hold window
   (4 cooldowns) freezes the actuator for the window and journals the
   hold.

Every applied decision is journaled in
``gordo_autopilot_decisions_total{actuator,direction,reason}``, as a
synthetic flight-recorder timeline, as an ``autopilot``/``decision``
control-ledger event, and in the bounded ring ``/autopilot`` serves.

The router's controller (:func:`build_router_autopilot`) has one
actuator, the elastic worker count (:mod:`.elastic`).
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..analysis import lockcheck
from ..observability import flightrec
from ..observability import ledger as control_ledger
from ..observability.registry import REGISTRY
from ..observability.spans import Timeline
from ..resilience import qos
from . import policy, signals
from .policy import DOWN, HOLD, UP, Actuator

logger = logging.getLogger(__name__)

_M_DECISIONS = REGISTRY.counter(
    "gordo_autopilot_decisions_total",
    "Autopilot adaptations by actuator, direction (up/down/hold) and "
    "reason (the policy rule that fired; hold = oscillation guard)",
    labels=("actuator", "direction", "reason"),
)
_M_ENABLED = REGISTRY.gauge(
    "gordo_autopilot_enabled",
    "Whether the closed-loop controller is currently adapting (0 = "
    "frozen or disabled; absent = hard kill switch)",
)
_M_VALUE = REGISTRY.gauge(
    "gordo_autopilot_value",
    "Current value of each autopilot-managed actuator (set on every "
    "applied adaptation)",
    labels=("actuator",),
)

_DIRECTION_NAMES = {UP: "up", DOWN: "down", HOLD: "hold"}

# how many cooldowns a second direction flip freezes an actuator for
_OSCILLATION_HOLD_COOLDOWNS = 4.0


def hard_off() -> bool:
    """Explicit ``GORDO_AUTOPILOT=0``: the hard kill switch — no
    controller exists, runtime enable impossible."""
    return os.environ.get("GORDO_AUTOPILOT", "").strip().lower() in (
        "0", "false", "off", "no",
    )


def enabled_at_boot() -> bool:
    """``GORDO_AUTOPILOT=1`` boots adapting; unset boots frozen but
    runtime-enableable."""
    return os.environ.get("GORDO_AUTOPILOT", "").strip().lower() in (
        "1", "true", "on", "yes",
    )


class _ActuatorState:
    __slots__ = (
        "pending_direction", "pending_count", "last_applied_at",
        "last_direction", "last_flip_at", "frozen_until", "last_decision",
    )

    def __init__(self):
        self.pending_direction = HOLD
        self.pending_count = 0
        self.last_applied_at: Optional[float] = None
        self.last_direction = HOLD
        self.last_flip_at: Optional[float] = None
        self.frozen_until: Optional[float] = None
        self.last_decision: Optional[Dict[str, Any]] = None


class Autopilot:
    """Scrape-driven closed-loop controller over a set of actuators."""

    def __init__(
        self,
        reader: signals.SignalReader,
        actuators: List[Actuator],
        role: str = "server",
        min_interval: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        recorder: Optional[flightrec.FlightRecorder] = None,
        enabled: Optional[bool] = None,
        history: int = 64,
    ):
        self.reader = reader
        self.actuators: Dict[str, Actuator] = {
            actuator.name: actuator for actuator in actuators
        }
        self.role = role
        self.min_interval = (
            min_interval if min_interval is not None
            else policy._env_float("GORDO_AUTOPILOT_INTERVAL", 5.0)
        )
        self._clock = clock
        self._recorder = recorder
        self._lock = lockcheck.named_lock("autopilot.state")
        self._enabled = (
            enabled if enabled is not None else enabled_at_boot()
        )
        self._disabled_reason: Optional[str] = (
            None if self._enabled else "disabled at boot (GORDO_AUTOPILOT "
            "unset; POST /autopilot/enable to start adapting)"
        )
        self._state: Dict[str, _ActuatorState] = {
            name: _ActuatorState() for name in self.actuators
        }
        self._decisions: "deque[Dict[str, Any]]" = deque(maxlen=history)
        self._last_tick: Optional[float] = None
        self._last_observation: Optional[signals.Observation] = None
        self.ticks = 0
        _M_ENABLED.set(1.0 if self._enabled else 0.0)

    # -- enablement ----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        with self._lock:
            return self._enabled

    def enable(self) -> None:
        with self._lock:
            self._enabled = True
            self._disabled_reason = None
        _M_ENABLED.set(1.0)
        logger.info("Autopilot (%s) enabled", self.role)
        control_ledger.emit(
            actor="autopilot", action="enable", target=self.role,
        )

    def disable(self, reason: str = "operator freeze") -> None:
        """The runtime kill switch: stop adapting NOW. Status stays
        readable; every per-actuator pending confirmation is reset so a
        later enable starts from a clean hysteresis window."""
        with self._lock:
            self._enabled = False
            self._disabled_reason = reason
            for state in self._state.values():
                state.pending_direction = HOLD
                state.pending_count = 0
        _M_ENABLED.set(0.0)
        logger.warning("Autopilot (%s) disabled: %s", self.role, reason)
        control_ledger.emit(
            actor="autopilot", action="disable", target=self.role,
            reason=reason,
        )

    def set_bounds(self, name: str, lo: int, hi: int) -> bool:
        """Re-aim one actuator's hard bounds at runtime, the fleet
        reconciler's ownership seam: the autopilot adapts freely INSIDE
        the envelope, the spec owns the envelope itself. The change is
        journaled like a decision (reason ``fleet_spec``); a no-op (same
        bounds) journals nothing. Returns whether the bounds changed."""
        actuator = self.actuators.get(name)
        if actuator is None:
            raise KeyError(f"unknown actuator {name!r}")
        with self._lock:
            old = actuator.bounds
            if (old.lo, old.hi) == (lo, hi):
                return False
            actuator.bounds = policy.Bounds(int(lo), int(hi))
            self._journal_locked(
                name, "bounds", "fleet_spec",
                value_from=None, value_to=None, now=self._clock(),
                extra={"bounds_from": [old.lo, old.hi],
                       "bounds_to": [int(lo), int(hi)]},
            )
        logger.info(
            "Autopilot (%s): %s bounds re-aimed [%d, %d] -> [%d, %d]",
            self.role, name, old.lo, old.hi, lo, hi,
        )
        return True

    # -- evaluation ----------------------------------------------------------
    def maybe_tick(self, now: Optional[float] = None) -> bool:
        """Scrape-path entry (like ``SLOEvaluator.maybe_tick``): tick
        when the min interval elapsed. Disabled controllers still gate
        the interval so a later enable doesn't burst-fire."""
        now = self._clock() if now is None else now
        with self._lock:
            due = (
                self._last_tick is None
                or now - self._last_tick >= self.min_interval
            )
            if due:
                # CLAIM the tick inside the lock: two concurrent scrapes
                # (an HA Prometheus pair) must not both tick, or a
                # confirm=N hysteresis collapses into one instant
                self._last_tick = now
        if due:
            self.tick(now)
        return due

    def tick(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One evaluation: read the signals, run every actuator's rule
        through hysteresis/cooldown/oscillation gates, apply and journal
        what survives. Returns the applied (and held) decisions."""
        now = self._clock() if now is None else now
        with self._lock:
            self._last_tick = now
            if not self._enabled:
                return []
            self.ticks += 1
        observation = self.reader.read(now)
        applied: List[Dict[str, Any]] = []
        with self._lock:
            if not self._enabled:  # disable() raced the signal read
                return []
            self._last_observation = observation
            for name, actuator in self.actuators.items():
                decision = self._evaluate_locked(
                    name, actuator, observation, now
                )
                if decision is not None:
                    applied.append(decision)
        return applied

    def _evaluate_locked(
        self,
        name: str,
        actuator: Actuator,
        observation: signals.Observation,
        now: float,
    ) -> Optional[Dict[str, Any]]:
        state = self._state[name]
        direction, reason = actuator.decide(observation)
        if direction == HOLD:
            state.pending_direction = HOLD
            state.pending_count = 0
            return None
        # hysteresis: the direction must persist `confirm` ticks
        if state.pending_direction == direction:
            state.pending_count += 1
        else:
            state.pending_direction = direction
            state.pending_count = 1
        if state.pending_count < actuator.confirm:
            return None
        # oscillation-guard freeze in force
        if state.frozen_until is not None and now < state.frozen_until:
            return None
        # cooldown: settle before the next turn of the same knob
        if (
            state.last_applied_at is not None
            and now - state.last_applied_at < actuator.cooldown
        ):
            return None
        is_flip = (
            state.last_direction != HOLD
            and direction != state.last_direction
        )
        hold_window = max(
            actuator.cooldown * _OSCILLATION_HOLD_COOLDOWNS,
            self.min_interval * _OSCILLATION_HOLD_COOLDOWNS,
        )
        if (
            is_flip
            and state.last_flip_at is not None
            and now - state.last_flip_at < hold_window
        ):
            # second flip inside the window: alternating directions mean
            # the two rules disagree faster than the system settles —
            # freeze the actuator and say so, loudly
            state.frozen_until = now + hold_window
            state.pending_direction = HOLD
            state.pending_count = 0
            held = self._journal_locked(
                name, "hold", "oscillation_guard",
                value_from=None, value_to=None, now=now,
                extra={"hold_seconds": round(hold_window, 3)},
            )
            state.last_decision = held
            return held
        try:
            current = int(actuator.read())
        except Exception:
            logger.exception("Autopilot: reading actuator %s failed", name)
            return None
        target = actuator.aimd.next_value(current, direction, actuator.bounds)
        if target == current:
            return None  # clamped at a bound: nothing to do, no journal
        try:
            result = actuator.apply(target)
        except Exception:
            logger.exception(
                "Autopilot: applying %s=%s failed (decision dropped)",
                name, target,
            )
            return None
        if actuator.skip_on_none and result is None:
            # the seam reported not-applicable (fully-resident engine,
            # no retire candidate, scale op in flight) — don't journal
            # a change that didn't happen, and don't burn the cooldown
            return None
        state.last_applied_at = now
        if is_flip:
            # first flip in a window is legitimate adaptation (load
            # changed); only the SECOND flip inside the window — checked
            # above — reads as oscillation
            state.last_flip_at = now
        state.last_direction = direction
        state.pending_direction = HOLD
        state.pending_count = 0
        _M_VALUE.labels(name).set(float(target))
        decision = self._journal_locked(
            name, _DIRECTION_NAMES[direction], reason,
            value_from=current, value_to=target, now=now,
        )
        state.last_decision = decision
        return decision

    # -- the decision journal ------------------------------------------------
    def _journal_locked(
        self,
        actuator: str,
        direction: str,
        reason: str,
        value_from: Optional[int],
        value_to: Optional[int],
        now: float,
        extra: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        decision = {
            "at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "tick": self.ticks,
            "actuator": actuator,
            "direction": direction,
            "reason": reason,
            "from": value_from,
            "to": value_to,
        }
        if extra:
            decision.update(extra)
        lockcheck.assert_guard("autopilot.state")
        self._decisions.append(decision)
        _M_DECISIONS.labels(actuator, direction, reason).inc()
        logger.info(
            "Autopilot (%s): %s %s (%s) %s -> %s",
            self.role, actuator, direction, reason, value_from, value_to,
        )
        recorder = (
            self._recorder if self._recorder is not None
            else flightrec.RECORDER
        )
        # flight-recorder entry: the adaptation lands in the SAME ring as
        # the requests it affected, so a /debug/requests read shows "the
        # depth changed HERE" next to the latencies that changed with it
        timeline = Timeline(
            f"autopilot-{actuator}-{int(time.time() * 1000)}",
            endpoint="autopilot",
        )
        timeline.add_event("autopilot_decision", **decision)
        timeline.finish(status="autopilot")
        try:
            recorder.record(timeline)
        except Exception:  # journaling must never break actuation
            logger.exception("Autopilot: flight-recorder journal failed")
        # the same decision lands in the shared control ledger (emit
        # never raises)
        control_ledger.emit(
            actor="autopilot", action="decision", target=actuator,
            before=value_from, after=value_to,
            reason=f"{direction}: {reason}",
        )
        return decision

    # -- views ---------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The ``/autopilot`` body (and the CLI dump): enablement, per-
        actuator live value/bounds/cooldown state, the decision ring,
        and the last observation the decisions were made from."""
        now = self._clock()
        with self._lock:
            actuators: Dict[str, Any] = {}
            for name, actuator in self.actuators.items():
                state = self._state[name]
                try:
                    value: Optional[int] = int(actuator.read())
                except Exception:  # noqa: BLE001  # lint: allow-swallow(status-view actuator read; a dark actuator renders as null and real decisions have their own journal)
                    value = None
                cooldown_left = 0.0
                if state.last_applied_at is not None:
                    cooldown_left = max(
                        0.0,
                        actuator.cooldown - (now - state.last_applied_at),
                    )
                actuators[name] = {
                    "value": value,
                    "bounds": [actuator.bounds.lo, actuator.bounds.hi],
                    "cooldown_s": actuator.cooldown,
                    "cooldown_remaining_s": round(cooldown_left, 3),
                    "confirm_ticks": actuator.confirm,
                    "pending": {
                        "direction": _DIRECTION_NAMES[
                            state.pending_direction
                        ],
                        "count": state.pending_count,
                    },
                    "frozen_for_s": (
                        round(max(0.0, state.frozen_until - now), 3)
                        if state.frozen_until is not None
                        and state.frozen_until > now
                        else 0.0
                    ),
                    "last_decision": state.last_decision,
                }
            return {
                "enabled": self._enabled,
                "hard_off": False,
                "role": self.role,
                "disabled_reason": self._disabled_reason,
                "interval_s": self.min_interval,
                "ticks": self.ticks,
                "actuators": actuators,
                "decisions": list(self._decisions),
                "observation": (
                    self._last_observation.summary()
                    if self._last_observation is not None else None
                ),
            }


def disabled_snapshot() -> Dict[str, Any]:
    """What the endpoints answer under the hard kill switch."""
    return {
        "enabled": False,
        "hard_off": True,
        "reason": "GORDO_AUTOPILOT=0 (hard kill switch; restart without "
                  "it to construct the controller)",
    }


# -- role assemblies ----------------------------------------------------------


def build_server_autopilot(server, clock=time.monotonic):
    """Wire a worker/server-side controller over the serving data plane:
    dispatch depth, fill window, admission bound, megabatch residency —
    all landing through ``ModelServer.apply_tuning`` (which survives
    reload generation swaps). None under the hard kill switch."""
    if hard_off():
        return None
    thresholds = policy.Thresholds.from_env()
    aimd = policy.default_aimd()
    cooldown = policy.cooldown_knob()
    confirm = policy.confirm_knob()
    reader = signals.SignalReader(
        slo=server.slo,
        recorder=flightrec.RECORDER,
        admission_stats=server.admission.stats,
        engine_stats=lambda: server.engine.stats(),
        request_count=lambda: signals.registry_counter_total(
            "gordo_server_requests_total",
            {"endpoint": ("anomaly", "prediction")},
        ),
        clock=clock,
    )
    # resolve the engine PER CALL: a reload swaps server._state, and a
    # bound method captured here would read (and tune) the dropped
    # generation forever
    def tuning():
        return server.engine.current_tuning()

    actuators = [
        Actuator(
            name="dispatch_depth",
            read=lambda: tuning()["dispatch_depth"],
            apply=lambda v: server.apply_tuning(dispatch_depth=v),
            decide=policy.depth_rule(thresholds),
            bounds=policy.bounds_knob(
                "GORDO_AUTOPILOT_DEPTH_BOUNDS", policy.Bounds(1, 8)
            ),
            aimd=aimd, cooldown=cooldown, confirm=confirm,
        ),
        Actuator(
            name="fill_window",
            read=lambda: tuning()["fill_window_us"],
            apply=lambda v: server.apply_tuning(fill_window_us=v),
            decide=policy.fill_rule(thresholds),
            bounds=policy.bounds_knob(
                "GORDO_AUTOPILOT_FILL_BOUNDS", policy.Bounds(0, 4000)
            ),
            aimd=aimd, cooldown=cooldown, confirm=confirm,
        ),
        Actuator(
            name="max_inflight",
            read=lambda: server.admission.max_inflight,
            apply=lambda v: server.apply_tuning(max_inflight=v),
            decide=policy.inflight_rule(thresholds),
            bounds=policy.bounds_knob(
                "GORDO_AUTOPILOT_INFLIGHT_BOUNDS", policy.Bounds(8, 256)
            ),
            aimd=aimd, cooldown=cooldown, confirm=confirm,
        ),
        Actuator(
            name="shed",
            read=lambda: server.admission.shed_level,
            apply=lambda v: server.apply_tuning(shed_level=v),
            decide=policy.shed_rule(thresholds),
            bounds=policy.bounds_knob(
                "GORDO_AUTOPILOT_SHED_BOUNDS",
                policy.Bounds(0, qos.SHED_MAX),
            ),
            aimd=aimd, cooldown=cooldown, confirm=confirm,
        ),
        Actuator(
            name="residency",
            read=lambda: tuning()["megabatch_residency"],
            # .get() surfaces the seam's not-applicable answer (None on
            # a fully-resident engine) so skip_on_none can honor it
            apply=lambda v: server.apply_tuning(
                megabatch_residency=v
            ).get("megabatch_residency"),
            decide=policy.residency_rule(thresholds),
            bounds=policy.bounds_knob(
                "GORDO_AUTOPILOT_RESIDENCY_BOUNDS", policy.Bounds(16, 1024)
            ),
            aimd=aimd, cooldown=cooldown, confirm=confirm,
            skip_on_none=True,
        ),
    ]
    return Autopilot(reader, actuators, role="server", clock=clock)


def build_router_autopilot(router, clock=time.monotonic):
    """Wire the router-side controller: ONE actuator, the elastic worker
    count, spawning/retiring through the existing supervisor slot table
    and consistent-hash ring (``elastic.ElasticWorkers``) on sustained
    burn or sustained idle. None under the hard kill switch."""
    if hard_off():
        return None
    from .elastic import ElasticWorkers

    thresholds = policy.Thresholds.from_env()
    elastic = ElasticWorkers(
        router.supervisor, router.control, router.placement,
    )
    reader = signals.SignalReader(
        slo=router.slo,
        recorder=flightrec.RECORDER,
        request_count=lambda: signals.registry_counter_total(
            "gordo_router_requests_total", {"outcome": "ok"}
        ),
        extras=lambda: {
            "elastic_busy": elastic.busy(),
            "workers": elastic.count(),
        },
        clock=clock,
    )
    worker_bounds = policy.bounds_knob(
        "GORDO_AUTOPILOT_WORKER_BOUNDS", policy.Bounds(1, 8)
    )
    actuators = [
        Actuator(
            name="workers",
            read=elastic.count,
            apply=elastic.apply_target,
            decide=policy.workers_rule(thresholds),
            bounds=worker_bounds,
            # ±1 worker per decision: AIMD degenerates to linear steps
            aimd=policy.AIMD(step=0.0, backoff=0.99),
            cooldown=policy.cooldown_knob(),
            confirm=policy.scale_ticks_knob(),
            # apply_target answers None when no op ran (op in flight,
            # no retire candidate) — never journal those
            skip_on_none=True,
        ),
    ]
    pilot = Autopilot(reader, actuators, role="router", clock=clock)
    pilot.elastic = elastic
    pilot.thresholds = thresholds
    pilot.static_idle_rps = thresholds.idle_rps
    return pilot
