"""The closed-loop autopilot (the port's copy of
``gordo_components_tpu/autopilot/``): the SLO engine drives the serving
knobs.

- :mod:`.signals`: normalized observations off the signal plane (SLO burn
  rates, flight-recorder span shares, admission occupancy, request rate);
- :mod:`.policy`: per-actuator AIMD with hysteresis, cooldowns and hard
  ``min:max`` bounds, every constant a ``GORDO_AUTOPILOT_*`` knob;
- :mod:`.controller`: the tick, the oscillation guard, the kill switches
  and the decision journal.

- :mod:`.elastic`: the router's actuator, the worker count, spawning
  and retiring worker processes through the supervisor and the ring.
"""

from __future__ import annotations

from .controller import (
    Autopilot,
    build_router_autopilot,
    build_server_autopilot,
    disabled_snapshot,
    enabled_at_boot,
    hard_off,
)
from .policy import AIMD, Actuator, Bounds, Thresholds, parse_bounds
from .signals import Observation, SignalReader

__all__ = [
    "AIMD",
    "Actuator",
    "Autopilot",
    "Bounds",
    "Observation",
    "SignalReader",
    "Thresholds",
    "build_router_autopilot",
    "build_server_autopilot",
    "disabled_snapshot",
    "enabled_at_boot",
    "hard_off",
    "parse_bounds",
]
