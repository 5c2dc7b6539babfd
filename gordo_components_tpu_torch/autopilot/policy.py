"""The autopilot's hands (the port's copy of
``gordo_components_tpu/autopilot/policy.py``): per-actuator AIMD inside
hard bounds, and the decision rules.

The serving knobs (dispatch depth, fill window, admission bound, the shed
ladder, residency, worker count) share TCP's congestion shape: pushing up
buys throughput until it buys latency. Additive increase probes while the
SLO is met; multiplicative decrease backs off the moment burn crosses the
line; every value stays inside operator-declared ``min:max`` bounds. The
constants are ``GORDO_AUTOPILOT_*`` knobs, and this module is pure
arithmetic: no locks, no clocks, no I/O.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional, Tuple

from .signals import Observation

UP, HOLD, DOWN = 1, 0, -1


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


class Bounds(NamedTuple):
    """Hard min/max an actuator may never leave, whatever the policy
    wants — the operator's safety rail."""

    lo: int
    hi: int

    def clamp(self, value: int) -> int:
        return max(self.lo, min(self.hi, int(value)))


def parse_bounds(spec: Optional[str], default: Bounds) -> Bounds:
    """``"min:max"`` → :class:`Bounds`; malformed or inverted specs fall
    back to the default (a typo'd knob must degrade to the shipped
    bounds, not crash the serving process at boot)."""
    if not spec:
        return default
    try:
        lo_text, hi_text = str(spec).split(":", 1)
        lo, hi = int(lo_text), int(hi_text)
    except (TypeError, ValueError):
        return default
    if lo > hi:
        return default
    return Bounds(lo, hi)


def bounds_knob(name: str, default: Bounds) -> Bounds:
    return parse_bounds(os.environ.get(name), default)


@dataclass(frozen=True)
class AIMD:
    """Additive-increase (``step`` fraction of current, min +1) /
    multiplicative-decrease (``backoff`` factor, min -1) — clamped by
    the actuator's bounds at the call site."""

    step: float = 0.5
    backoff: float = 0.5

    def up(self, value: int, bounds: Bounds) -> int:
        grown = max(value + 1, int(math.floor(value * (1.0 + self.step))))
        return bounds.clamp(grown)

    def down(self, value: int, bounds: Bounds) -> int:
        shrunk = min(value - 1, int(math.floor(value * self.backoff)))
        return bounds.clamp(shrunk)

    def next_value(self, value: int, direction: int, bounds: Bounds) -> int:
        if direction == UP:
            return self.up(value, bounds)
        if direction == DOWN:
            return self.down(value, bounds)
        return bounds.clamp(value)


def default_aimd() -> AIMD:
    return AIMD(
        step=max(0.0, _env_float("GORDO_AUTOPILOT_STEP", 0.5)),
        backoff=min(
            0.99, max(0.01, _env_float("GORDO_AUTOPILOT_BACKOFF", 0.5))
        ),
    )


@dataclass
class Actuator:
    """One tunable knob under closed-loop control.

    ``read`` returns the live value; ``apply`` lands a new one (it may
    return None to report "not applicable right now" — e.g. residency on
    a fully-resident engine — which the controller journals as a skip).
    ``decide`` maps an :class:`Observation` to ``(direction, reason)``;
    ``confirm`` is the hysteresis (consecutive ticks a direction must
    persist before acting); ``cooldown`` the settling time between
    applied changes."""

    name: str
    read: Callable[[], int]
    apply: Callable[[int], Any]
    decide: Callable[[Observation], Tuple[int, str]]
    bounds: Bounds
    aimd: AIMD = field(default_factory=AIMD)
    cooldown: float = 30.0
    confirm: int = 2
    # opt-in not-applicable contract: when True, an apply returning
    # None means "nothing was actually changed" (a fully-resident
    # engine's residency, an elastic op with no retire candidate) and
    # the controller skips the journal instead of recording a phantom
    # adaptation. Off by default — most appliers return None as a
    # plain procedure.
    skip_on_none: bool = False


@dataclass
class Thresholds:
    """The decision rules' shared water marks, resolved from knobs once
    per controller construction."""

    burn_high: float = 1.0
    burn_low: float = 0.25
    idle_rps: float = 1.0

    @classmethod
    def from_env(cls) -> "Thresholds":
        return cls(
            burn_high=_env_float("GORDO_AUTOPILOT_BURN_HIGH", 1.0),
            burn_low=_env_float("GORDO_AUTOPILOT_BURN_LOW", 0.25),
            idle_rps=_env_float("GORDO_AUTOPILOT_IDLE_RPS", 1.0),
        )


def cooldown_knob() -> float:
    return max(0.0, _env_float("GORDO_AUTOPILOT_COOLDOWN", 30.0))


def confirm_knob() -> int:
    return max(1, _env_int("GORDO_AUTOPILOT_CONFIRM", 2))


def scale_ticks_knob() -> int:
    return max(1, _env_int("GORDO_AUTOPILOT_SCALE_TICKS", 3))


# -- decision rules -----------------------------------------------------------
#
# Each rule returns (direction, reason). Reasons are a closed enum (they
# label gordo_autopilot_decisions_total) — keep them few and stable.


def depth_rule(
    thresholds: Thresholds,
) -> Callable[[Observation], Tuple[int, str]]:
    """Dispatch depth: deepen the pipeline while the SLO is met and
    requests are standing in line (queue_wait dominating with traffic
    flowing means the device could overlap more); back off when burn is
    high and the device side dominates — a deep pipeline is then just
    queueing latency inside the engine."""

    def decide(obs: Observation) -> Tuple[int, str]:
        if obs.burn_fast >= thresholds.burn_high and (
            obs.device_share >= 0.5
        ):
            return DOWN, "burn_device"
        if (
            obs.burn_fast <= thresholds.burn_low
            and obs.queue_share >= 0.35
            and obs.sampled_requests >= 5
        ):
            return UP, "queue_wait"
        return HOLD, ""

    return decide


def fill_rule(
    thresholds: Thresholds,
) -> Callable[[Observation], Tuple[int, str]]:
    """Fill window: widen it while healthy and queueing (more fusion per
    dispatch); shrink when burn is high and the fill wait itself shows
    up in the latency breakdown."""

    def decide(obs: Observation) -> Tuple[int, str]:
        if obs.burn_fast >= thresholds.burn_high and (
            obs.fill_share >= 0.15
        ):
            return DOWN, "fill_latency"
        if (
            obs.burn_fast <= thresholds.burn_low
            and obs.queue_share >= 0.35
            and obs.sampled_requests >= 5
            and obs.extras.get("mega_enabled")
        ):
            return UP, "queue_wait"
        return HOLD, ""

    return decide


def inflight_rule(
    thresholds: Thresholds,
) -> Callable[[Observation], Tuple[int, str]]:
    """Admission bound: shed earlier when burn is high and the time goes
    to queueing (an admitted-but-doomed request costs a thread and a
    dispatch; the gate is the cheapest place to say no); raise it while
    healthy with the gate itself as the limiter."""

    def decide(obs: Observation) -> Tuple[int, str]:
        if obs.burn_fast >= thresholds.burn_high and (
            obs.queue_share >= 0.5 or obs.queue_depth > 0
        ):
            return DOWN, "burn_queue"
        if (
            obs.burn_fast <= thresholds.burn_low
            and obs.inflight_frac >= 0.9
        ):
            return UP, "gate_full"
        return HOLD, ""

    return decide


def residency_rule(
    thresholds: Thresholds,
) -> Callable[[Observation], Tuple[int, str]]:
    """Megabatch residency (partial-residency engines only): grow the
    resident set while healthy and the cap is full (more machines fuse
    instead of earning slots); release it on sustained idle — resident
    stacks are device memory nobody is using."""

    def decide(obs: Observation) -> Tuple[int, str]:
        cap = obs.extras.get("residency_cap") or 0
        resident = obs.extras.get("resident_machines") or 0
        machines = obs.extras.get("machines") or 0
        if not obs.extras.get("mega_enabled") or machines <= cap:
            return HOLD, ""  # fully resident: nothing to turn
        if (
            obs.burn_fast <= thresholds.burn_low
            and cap > 0
            and resident >= cap
        ):
            return UP, "residency_full"
        if obs.rps < thresholds.idle_rps and obs.burn_fast == 0.0:
            return DOWN, "idle"
        return HOLD, ""

    return decide


def shed_rule(
    thresholds: Thresholds,
) -> Callable[[Observation], Tuple[int, str]]:
    """Shed ladder: on SUSTAINED burn — the fast window over the
    line while the slow window is already elevated, so one latency
    spike cannot squeeze anyone — climb a rung, progressively
    tightening ONLY the bulk class's admission share. Relax back down
    the ladder once the fast window is quiet. UP here means "shed
    more", and the ladder's own hysteresis/cooldown/oscillation guards
    are the controller's, same as every other actuator."""

    def decide(obs: Observation) -> Tuple[int, str]:
        if (
            obs.burn_fast >= thresholds.burn_high
            and obs.burn_slow >= thresholds.burn_low
        ):
            return UP, "sustained_burn"
        if obs.burn_fast <= thresholds.burn_low:
            return DOWN, "burn_recovered"
        return HOLD, ""

    return decide


def workers_rule(
    thresholds: Thresholds,
) -> Callable[[Observation], Tuple[int, str]]:
    """Elastic worker count: spawn on sustained burn (the fleet is not
    keeping its objectives and more processes are the coarsest, surest
    relief); retire on sustained idle — zero burn on both windows AND a
    request rate under the idle floor. The ``confirm`` hysteresis on
    this actuator is the SCALE_TICKS knob, so "sustained" is measured in
    evaluation ticks, not one noisy sample."""

    def decide(obs: Observation) -> Tuple[int, str]:
        busy = obs.extras.get("elastic_busy")
        if busy:
            return HOLD, ""  # one scale op at a time
        if obs.burn_fast >= thresholds.burn_high:
            return UP, "sustained_burn"
        if (
            obs.rps < thresholds.idle_rps
            and obs.burn_fast <= thresholds.burn_low
            and obs.burn_slow <= thresholds.burn_low
        ):
            return DOWN, "sustained_idle"
        return HOLD, ""

    return decide
