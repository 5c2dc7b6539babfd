"""What one run hands the metric readers (``metrics/<name>.py``), and the
arithmetic they share."""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

SERIES = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")


@dataclass
class Run:
    cell: Dict
    config: Dict
    traffic: Dict
    t0: float                   # the window, on time.monotonic()
    t1: float
    setup_s: float
    collected: float            # when the last answer was in (or given up)
    records: List[Dict]         # per request: body, due, sent, done, status, windows
    memory_window_bytes: int = 0
    prom: Optional[Dict[str, Dict[str, float]]] = None  # "before"/"after" /metrics
    trace: Optional[Dict] = None  # trace.Trace.stop()'s reading
    extra: Dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def ok(self, rec: Dict) -> bool:
        return rec["status"] == 200

    def due_in_window(self) -> List[Dict]:
        """The requests the window owes: an open loop's scheduled in it, a
        closed loop's sent in it."""
        return [r for r in self.records if self.t0 <= self._start(r) < self.t1]

    @staticmethod
    def _start(rec: Dict) -> float:
        """When a request was due (open loop) or went out (closed loop)."""
        return rec["due"] if rec["due"] is not None else rec["sent"]

    def windows_scored(self) -> float:
        """Windows of answered requests, each request counted by the share
        of its time in flight that lies inside the window."""
        total = 0.0
        for r in self.records:
            if not self.ok(r):
                continue
            span = r["done"] - r["sent"]
            inside = min(r["done"], self.t1) - max(r["sent"], self.t0)
            if inside > 0:
                total += r["windows"] * (inside / span if span > 0 else 1.0)
        return total

    def latency_s(self, rec: Dict) -> float:
        """From the request's due (or send) time to its last byte; a failed
        request waited until the answers were collected, longer than any."""
        if not self.ok(rec):
            return self.collected - self._start(rec) + 1.0
        return rec["done"] - self._start(rec)

    def prom_delta(self, name: str, **labels: str) -> Optional[float]:
        """The change of a /metrics series over the window, summed over the
        series of that name whose labels include ``labels``."""
        if self.prom is None:
            return None
        want = [f'{k}="{v}"' for k, v in labels.items()]

        def total(snapshot):
            return sum(v for key, v in snapshot.items()
                       if key.split("{")[0] == name and all(w in key for w in want))

        return total(self.prom["after"]) - total(self.prom["before"])


def percentile(values: List[float], q: float) -> float:
    """Nearest rank: the smallest value with at least ``q`` percent of the
    values at or below it."""
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def parse_prometheus(text: str) -> Dict[str, float]:
    out = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        match = SERIES.match(line.strip())
        if match:
            try:
                out[match.group(1) + (match.group(2) or "")] = float(match.group(3))
            except ValueError:
                pass
    return out
