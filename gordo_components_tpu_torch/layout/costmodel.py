"""Measured-cost scoring for candidate fleet layouts (the port's copy of
``gordo_components_tpu/layout/costmodel.py``).

The model is intentionally a PROXY, not a simulator: it ranks candidate
layouts on three terms the telemetry warehouse actually measures, and
live measurements gate the REAL p99 and bytes numbers on a running
fleet — the model only has to order candidates correctly, not predict
latencies absolutely.

Terms (all computed from one ``gordo-layout-input/v1`` document plus a
candidate machine→worker assignment):

- **imbalance** — max worker load / mean worker load over the measured
  per-machine rates. The single-worker ceiling is the serving tier's
  binding constraint; queueing delay grows superlinearly in utilization,
  so the p99 proxy weights this term quadratically.
- **expected residency hit rate** — the traffic share landing on
  machines inside their worker's resident set. A megabatch-resident
  machine dispatches through the stacked program; everything else pays
  the host path, so (1 - hit rate) is the model's slow-path mass.
- **device bytes / machines-per-GiB** — per-rung device bytes from the
  engine's cost ledger, with precision downgrades projected at the
  ladder's byte ratios (bf16 halves, int8 quarters the stacked tree).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

#: device-byte ratio of each rung relative to f32
RUNG_BYTE_RATIO = {"f32": 1.0, "bf16": 0.5, "int8": 0.25}

_GIB = float(1 << 30)


def machine_rates(doc: Dict[str, Any]) -> Dict[str, float]:
    """Per-machine representative request rate from a layout-input doc:
    the resolved ``rate`` field when the exporter provided one, else the
    doc's own horizon label looked up in the multi-horizon map, else
    the first horizon present. Machines with no measured rate at all
    plan at 0.0 (they still get placed — by name hash, like today)."""
    horizon = doc.get("horizon")
    rates: Dict[str, float] = {}
    for m in doc.get("machines") or ():
        name = m.get("machine")
        if not name:
            continue
        rate = m.get("rate")
        if rate is None:
            table = m.get("rates") or {}
            if horizon in table:
                rate = table[horizon]
            elif table:
                rate = next(iter(table.values()))
            else:
                rate = 0.0
        rates[str(name)] = max(0.0, float(rate))
    return rates


def mean_machine_bytes(doc: Dict[str, Any]) -> float:
    """Fleet-mean device bytes per machine from the per-rung cost
    ledger. The export aggregates bytes per RUNG, not per machine, so
    the model works in fleet means — good enough to rank layouts (the
    bench measures the real number)."""
    total_bytes = 0.0
    total_machines = 0.0
    for entry in (doc.get("rungs") or {}).values():
        total_bytes += float(entry.get("device_bytes") or 0.0)
        total_machines += float(entry.get("machines") or 0.0)
    if total_machines <= 0:
        return 0.0
    return total_bytes / total_machines


def base_latency_s(doc: Dict[str, Any]) -> float:
    """Request-weighted mean dispatch latency across rungs — the p99
    proxy's scale factor."""
    seconds = 0.0
    requests = 0.0
    for entry in (doc.get("rungs") or {}).values():
        seconds += float(entry.get("dispatch_seconds_total") or 0.0)
        requests += float(entry.get("requests") or 0.0)
    if requests <= 0:
        return 0.0
    return seconds / requests


class CostModel:
    """Scores a candidate layout against one layout-input document."""

    def __init__(self, doc: Dict[str, Any]):
        self.doc = doc
        self.rates = machine_rates(doc)
        self.total_rps = sum(self.rates.values())
        self.bytes_per_machine = mean_machine_bytes(doc)
        self.base_latency_s = base_latency_s(doc)

    # -- per-term metrics ----------------------------------------------------
    def worker_loads(
        self, assignment: Dict[str, str], workers: List[str]
    ) -> Dict[str, float]:
        """Measured rps landing on each worker under ``assignment``
        (machine → worker). Workers with no machines still appear (their
        idle capacity is exactly what a rebalance should use)."""
        loads = {worker: 0.0 for worker in workers}
        for machine, worker in assignment.items():
            if worker in loads:
                loads[worker] += self.rates.get(machine, 0.0)
        return loads

    def imbalance(self, loads: Dict[str, float]) -> float:
        """max/mean worker load; 1.0 = perfectly balanced. An empty or
        idle fleet scores a neutral 1.0 (nothing to balance)."""
        if not loads:
            return 1.0
        mean = sum(loads.values()) / len(loads)
        if mean <= 0:
            return 1.0
        return max(loads.values()) / mean

    def expected_hit_rate(
        self,
        assignment: Dict[str, str],
        resident: Dict[str, List[str]],
    ) -> float:
        """Traffic share landing on megabatch-resident machines: the
        fleet-wide expected residency hit rate under the measured rate
        distribution."""
        if self.total_rps <= 0:
            return 1.0
        resident_sets = {
            worker: set(names) for worker, names in resident.items()
        }
        hit = sum(
            self.rates.get(machine, 0.0)
            for machine, worker in assignment.items()
            if machine in resident_sets.get(worker, ())
        )
        return min(1.0, hit / self.total_rps)

    def device_bytes(self, precision: Dict[str, str]) -> float:
        """Projected fleet device bytes after the plan's precision
        downgrades (machines not in ``precision`` keep their measured
        mean footprint)."""
        n_machines = len(self.rates) or len(
            self.doc.get("machines") or ()
        )
        base = self.bytes_per_machine * n_machines
        if base <= 0:
            return 0.0
        saved = sum(
            self.bytes_per_machine * (1.0 - RUNG_BYTE_RATIO.get(rung, 1.0))
            for machine, rung in precision.items()
            if machine in self.rates
        )
        return max(0.0, base - saved)

    def machines_per_gib(self, precision: Dict[str, str]) -> float:
        """Machines served per GiB of device bytes — the density metric
        the acceptance gate compares (higher is better)."""
        projected = self.device_bytes(precision)
        if projected <= 0:
            return 0.0
        n_machines = len(self.rates) or len(
            self.doc.get("machines") or ()
        )
        return n_machines / (projected / _GIB)

    def p99_proxy_s(self, loads: Dict[str, float], hit_rate: float) -> float:
        """Traffic-weighted p99 contribution proxy: base dispatch
        latency scaled by the squared imbalance (queueing grows
        superlinearly toward the hottest worker's ceiling) plus the
        slow-path mass that misses residency. A ranking device, not a
        latency prediction."""
        imbalance = self.imbalance(loads)
        return self.base_latency_s * (
            imbalance * imbalance + 2.0 * (1.0 - hit_rate)
        )

    # -- the scalar objective ------------------------------------------------
    def score(
        self,
        assignment: Dict[str, str],
        workers: List[str],
        resident: Dict[str, List[str]],
        precision: Optional[Dict[str, str]] = None,
    ) -> Tuple[float, Dict[str, float]]:
        """Scalar cost (lower is better) plus the per-term breakdown
        recorded into the plan's ``cost`` block."""
        precision = precision or {}
        loads = self.worker_loads(assignment, workers)
        imbalance = self.imbalance(loads)
        hit_rate = self.expected_hit_rate(assignment, resident)
        per_gib = self.machines_per_gib(precision)
        p99 = self.p99_proxy_s(loads, hit_rate)
        # normalized terms: imbalance dominates (it is the measured
        # binding constraint), residency misses next, bytes last (a
        # tie-breaker — the parity budget already bounds the downgrades)
        scalar = (
            (imbalance - 1.0)
            + (1.0 - hit_rate)
            + 0.1 * (1.0 / (1.0 + per_gib) if per_gib > 0 else 0.0)
        )
        return scalar, {
            "imbalance": round(imbalance, 4),
            "expected_hit_rate": round(hit_rate, 4),
            "machines_per_gib": round(per_gib, 2),
            "device_gib": round(self.device_bytes(precision) / _GIB, 4),
            "p99_proxy_ms": round(p99 * 1000.0, 3),
            "worker_rps": {
                worker: round(load, 3)
                for worker, load in sorted(loads.items())
            },
        }
