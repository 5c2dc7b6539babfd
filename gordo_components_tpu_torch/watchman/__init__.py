"""Watchman (the port's copy of ``gordo_components_tpu/watchman/``): the
fleet-health aggregator (``server``) and the control plane that probes,
ejects and respawns a router's workers (``control``)."""

from .control import ControlPlane, jittered_interval
from .server import (
    WatchmanServer,
    build_watchman_app,
    make_watchman_server,
    read_build_progress,
    run_watchman,
    watch_build_progress,
)

__all__ = [
    "ControlPlane",
    "WatchmanServer",
    "build_watchman_app",
    "jittered_interval",
    "make_watchman_server",
    "read_build_progress",
    "run_watchman",
    "watch_build_progress",
]
