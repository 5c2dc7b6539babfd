"""Phase timing and device traces (the port's copy of
``gordo_components_tpu/utils/profiling.py:1-90``).

:class:`PhaseTimer`'s report drops into build metadata (``build_phases``)
and its totals into the metrics registry; :func:`device_trace` wraps a
block in ``torch.profiler`` and writes a Chrome trace (where the reference
wrote a ``jax.profiler`` trace).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any, Dict, Iterator, Optional

logger = logging.getLogger(__name__)

TRACE_FILE = "trace.json"


class PhaseTimer:
    """Accumulates named phase durations; ``report()`` is JSON-able."""

    def __init__(self) -> None:
        self.durations: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        started = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - started
            self.add(name, elapsed)
            logger.debug("phase %s: %.3fs", name, elapsed)

    def add(self, name: str, seconds: float) -> None:
        """Record a duration measured elsewhere."""
        self.durations[name] = self.durations.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, Any]:
        return {
            name: {"total_s": total, "count": self.counts[name]}
            for name, total in sorted(self.durations.items())
        }

    def publish(self, prefix: str = "gordo_build") -> None:
        """Add this timer's totals to ``<prefix>_phase_seconds_total{phase}``
        and ``<prefix>_phase_runs_total{phase}`` in the process registry."""
        from ..observability.registry import REGISTRY

        seconds = REGISTRY.counter(f"{prefix}_phase_seconds_total",
                                   "Cumulative wall-clock seconds spent per build phase",
                                   labels=("phase",))
        runs = REGISTRY.counter(f"{prefix}_phase_runs_total", "Times each build phase ran",
                                labels=("phase",))
        for name, total in self.durations.items():
            seconds.labels(name).inc(total)
            runs.labels(name).inc(self.counts[name])


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the block under ``torch.profiler`` (host, and the card when
    there is one) and write ``<log_dir>/trace.json``, a Chrome trace; a
    no-op without ``log_dir``."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    logger.info("Device trace written to %s", path)
