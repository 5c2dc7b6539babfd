"""Compile a ``gordo-layout-input/v1`` document into a layout plan (the
port's copy of ``gordo_components_tpu/layout/compiler.py``: the same
document compiles to the same bytes in either package).

The compiler is DETERMINISTIC: same input document + same parameters →
byte-identical plan (and therefore the same fingerprint). Nothing here
reads a clock or RNG — ``generated_t`` is copied from the input doc,
iteration orders are sorted, and weights are quantized to 1/32 so
floating-point noise cannot leak into the artifact.

Placement optimization simulates the REAL ring (``HashRing`` from
router.placement — pure stdlib) under candidate weight vectors, so what
the plan promises is exactly what ``Placement.set_worker_weights``
produces at apply time. The loop is a damped multiplicative-weights
rebalance: a few rounds of ``weight *= (mean/load)^0.5`` against the
measured per-machine rates, keeping the best-scoring round. Bounded
key movement is inherited from the ring (a weight change resizes only
that worker's arcs), so even a large rebalance moves few machines.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from ..observability.telemetry import validate_layout_input
from ..router.placement import HashRing
from .costmodel import CostModel
from .plan import PLAN_SCHEMA, plan_fingerprint

#: compiler weight clamp — tighter than the ring's own [0.1, 8.0] guard
#: rail: a computed plan should nudge shares, not starve a worker
_WEIGHT_MIN, _WEIGHT_MAX = 0.25, 4.0
_WEIGHT_GRAIN = 32.0  # quantize to 1/32 — determinism + readable plans
_REBALANCE_ROUNDS = 6
#: prefetch hints per worker: enough to pre-warm the next-hottest spill
#: machines without turning the hint into a full fleet load
_PREFETCH_PER_WORKER = 4
#: machine rates recorded into plan.source for the drift check
_SOURCE_RATES_TOP = 64

#: parity budget each downgraded rung spends, per unit of traffic share
#: (matches precision._DEFAULT_BUDGETS — the quant smoke's measured
#: normalized-error budgets)
_RUNG_PARITY_COST = {"bf16": 0.02, "int8": 0.08}


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return default


def _quantize(weight: float) -> float:
    weight = min(_WEIGHT_MAX, max(_WEIGHT_MIN, weight))
    return round(weight * _WEIGHT_GRAIN) / _WEIGHT_GRAIN


def _assignment(ring: HashRing, machines: List[str]) -> Dict[str, str]:
    return {
        machine: ring.primary(machine) or "" for machine in machines
    }


def _resident_sets(
    assignment: Dict[str, str],
    rates: Dict[str, float],
    workers: List[str],
    cap: Optional[int],
) -> Dict[str, List[str]]:
    """Per-worker resident set: the worker's assigned machines by
    descending measured rate, up to ``cap`` (zero-rate machines are
    never pinned — a pin they don't use would squat a megabatch slot).
    This replaces 2-hit LRU promotion ALONE with expected-hit-rate
    choice; the LRU still runs underneath for unplanned traffic."""
    by_worker: Dict[str, List[str]] = {worker: [] for worker in workers}
    for machine, worker in assignment.items():
        if worker in by_worker:
            by_worker[worker].append(machine)
    resident: Dict[str, List[str]] = {}
    for worker, names in by_worker.items():
        hot = sorted(
            (m for m in names if rates.get(m, 0.0) > 0.0),
            key=lambda m: (-rates.get(m, 0.0), m),
        )
        limit = int(cap) if cap is not None else min(16, len(hot))
        resident[worker] = hot[:limit]
    return resident


def _plan_precision(
    rates: Dict[str, float],
    total_rps: float,
    parity_budget: float,
    spec_precisions: Optional[Dict[str, str]],
) -> Dict[str, str]:
    """Greedy precision downgrades within the traffic × parity budget:
    each downgraded machine spends ``(its traffic share) × (its rung's
    parity budget)`` of the fleet budget. Coldest machines first — the
    byte savings per machine are equal (fleet-mean footprint) while the
    parity spend is rate-proportional, so ascending-rate order downgrades
    the MOST machines (and the least latency-critical ones) per unit of
    budget. Machines the spec pins explicitly are never overridden —
    the declared spec owns precision; the plan only fills the gaps."""
    if parity_budget <= 0.0 or total_rps <= 0.0:
        return {}
    pinned = spec_precisions or {}
    spent = 0.0
    plan: Dict[str, str] = {}
    for machine in sorted(rates, key=lambda m: (rates[m], m)):
        if machine in pinned:
            continue
        share = rates[machine] / total_rps
        for rung in ("int8", "bf16"):
            cost = share * _RUNG_PARITY_COST[rung]
            if spent + cost <= parity_budget:
                plan[machine] = rung
                spent += cost
                break
    return plan


def compile_plan(
    doc: Dict[str, Any],
    workers: Optional[List[str]] = None,
    vnodes: int = 64,
    residency_cap: Optional[int] = None,
    parity_budget: Optional[float] = None,
    spec_precisions: Optional[Dict[str, str]] = None,
) -> Dict[str, Any]:
    """Compile a validated layout-input document into a
    ``gordo-layout-plan/v1`` artifact. Raises ``ValueError`` on an
    invalid input document (callers decide whether that is a CLI error
    or a skipped re-derive). ``workers`` overrides the doc's own source
    worker list (the live reconciler passes the CURRENT ready set so a
    plan never assigns to a worker that already left); ``vnodes`` must
    match the live ring for the simulation to be exact (the fleet-wide
    default is 64). ``spec_precisions`` are the FleetSpec's explicit
    per-machine pins, which always win over the compiler's choices."""
    problems = validate_layout_input(doc)
    if problems:
        raise ValueError(
            "layout-input document invalid: " + "; ".join(problems[:5])
        )
    if parity_budget is None:
        parity_budget = _env_float("GORDO_LAYOUT_PARITY_BUDGET", 0.0)
    model = CostModel(doc)
    rates = model.rates
    machines = sorted(rates)
    if workers is None:
        workers = [
            str(w) for w in (doc.get("source") or {}).get("workers") or ()
            if w
        ]
    workers = sorted(set(workers))
    if not workers:
        raise ValueError("layout-input document names no workers")

    # baseline: the uniform name-hash ring (what the fleet does today)
    ring = HashRing(workers, vnodes=vnodes)
    baseline_assignment = _assignment(ring, machines)
    baseline_resident = _resident_sets(
        baseline_assignment, rates, workers, residency_cap
    )
    _, baseline_cost = model.score(
        baseline_assignment, workers, baseline_resident
    )

    # damped multiplicative-weights rebalance against the measured rates
    weights = {worker: 1.0 for worker in workers}
    best = (baseline_assignment, dict(weights))
    best_score, _ = model.score(
        baseline_assignment, workers, baseline_resident
    )
    for _ in range(_REBALANCE_ROUNDS):
        loads = model.worker_loads(_assignment(ring, machines), workers)
        mean = sum(loads.values()) / len(workers)
        if mean <= 0:
            break
        changed = False
        for worker in workers:
            # floor idle workers at 5% of mean so one empty worker
            # cannot demand an unbounded weight in a single round
            load = max(loads[worker], 0.05 * mean)
            target = _quantize(weights[worker] * (mean / load) ** 0.5)
            if target != weights[worker]:
                weights[worker] = target
                ring.set_weight(worker, target)
                changed = True
        candidate = _assignment(ring, machines)
        resident = _resident_sets(candidate, rates, workers, residency_cap)
        score, _ = model.score(candidate, workers, resident)
        if score < best_score:
            best_score = score
            best = (candidate, dict(weights))
        if not changed:
            break
    assignment, weights = best
    weights = {
        worker: weight for worker, weight in weights.items()
        if weight != 1.0
    }

    resident = _resident_sets(assignment, rates, workers, residency_cap)
    precision = _plan_precision(
        rates, model.total_rps, parity_budget, spec_precisions
    )
    _, plan_cost = model.score(assignment, workers, resident, precision)

    residency_workers: Dict[str, Any] = {}
    for worker in workers:
        names = resident.get(worker) or []
        worker_rps = sum(
            rates.get(m, 0.0)
            for m, w in assignment.items() if w == worker
        )
        hit = (
            sum(rates.get(m, 0.0) for m in names) / worker_rps
            if worker_rps > 0 else None
        )
        residency_workers[worker] = {
            "resident": names,
            "expected_hit_rate": round(hit, 4) if hit is not None else None,
        }

    prefetch: Dict[str, List[str]] = {}
    for worker in workers:
        pinned = set(resident.get(worker) or ())
        spill = sorted(
            (
                m for m, w in assignment.items()
                if w == worker and m not in pinned
                and rates.get(m, 0.0) > 0.0
            ),
            key=lambda m: (-rates.get(m, 0.0), m),
        )[:_PREFETCH_PER_WORKER]
        if spill:
            prefetch[worker] = spill

    baseline_loads = model.worker_loads(baseline_assignment, workers)
    mean_load = (
        sum(baseline_loads.values()) / len(workers) if workers else 0.0
    )
    moves = []
    for machine in machines:
        src = baseline_assignment.get(machine, "")
        dst = assignment.get(machine, "")
        if src == dst:
            continue
        src_ratio = (
            baseline_loads.get(src, 0.0) / mean_load if mean_load > 0
            else 0.0
        )
        moves.append({
            "machine": machine,
            "from": src,
            "to": dst,
            "rps": round(rates.get(machine, 0.0), 3),
            "reason": (
                f"{src} carried {src_ratio:.2f}x the mean measured load"
                if src_ratio > 1.0 else "ring arcs resized by weights"
            ),
        })

    plan: Dict[str, Any] = {
        "schema": PLAN_SCHEMA,
        "generated_t": float(doc.get("generated_t") or 0.0),
        "workers": workers,
        "weights": weights,
        "residency": {
            "cap": int(residency_cap) if residency_cap is not None else None,
            "workers": residency_workers,
        },
        "precision": precision,
        "prefetch": prefetch,
        "source": {
            "schema": doc.get("schema"),
            "generated_t": float(doc.get("generated_t") or 0.0),
            "window_s": float(doc.get("window_s") or 0.0),
            "horizon": doc.get("horizon"),
            "total_rps": round(model.total_rps, 3),
            "rates": {
                machine: round(rates[machine], 3)
                for machine in sorted(
                    rates, key=lambda m: (-rates[m], m)
                )[:_SOURCE_RATES_TOP]
            },
        },
        "cost": {"baseline": baseline_cost, "plan": plan_cost},
        "moves": moves,
    }
    plan["fingerprint"] = plan_fingerprint(plan)
    return plan


def staleness(
    plan: Dict[str, Any],
    doc: Dict[str, Any],
    max_age_s: Optional[float] = None,
    drift_limit: Optional[float] = None,
) -> Optional[str]:
    """Judge a committed plan against FRESH telemetry: returns a reason
    string when the plan should be re-derived, None while it stands.
    Two triggers (the staleness contract):

    - **age** — the telemetry the plan was computed from is older than
      ``GORDO_LAYOUT_MAX_AGE`` seconds relative to the fresh doc.
    - **drift** — the measured rate DISTRIBUTION moved: total variation
      distance between the plan's recorded machine-rate shares and the
      fresh ones exceeds ``GORDO_LAYOUT_DRIFT`` (0..1; 0.5 means half
      the traffic mass moved machines).

    Both clocks come from the telemetry documents themselves, so the
    check is valid wherever those timestamps are mutually consistent
    (same warehouse lineage) and degrades to age-only when not."""
    if max_age_s is None:
        max_age_s = _env_float("GORDO_LAYOUT_MAX_AGE", 900.0)
    if drift_limit is None:
        drift_limit = _env_float("GORDO_LAYOUT_DRIFT", 0.35)
    source = plan.get("source") or {}
    plan_t = float(source.get("generated_t") or plan.get("generated_t")
                   or 0.0)
    doc_t = float(doc.get("generated_t") or 0.0)
    if max_age_s > 0 and plan_t > 0 and doc_t - plan_t > max_age_s:
        return (
            f"plan telemetry is {doc_t - plan_t:.0f}s old "
            f"(max {max_age_s:.0f}s)"
        )
    old = {
        str(machine): max(0.0, float(rate))
        for machine, rate in (source.get("rates") or {}).items()
    }
    new = machine_rates_for_drift(doc)
    old_total, new_total = sum(old.values()), sum(new.values())
    if drift_limit > 0 and old_total > 0 and new_total > 0:
        tv = 0.5 * sum(
            abs(old.get(m, 0.0) / old_total - new.get(m, 0.0) / new_total)
            for m in set(old) | set(new)
        )
        if tv > drift_limit:
            return (
                f"rate distribution drifted {tv:.2f} "
                f"(limit {drift_limit:.2f})"
            )
    return None


def machine_rates_for_drift(doc: Dict[str, Any]) -> Dict[str, float]:
    """The fresh doc's machine rates, tolerant of invalid documents
    (staleness runs on every reconciler tick — a malformed scrape must
    degrade to 'no drift signal', never raise)."""
    try:
        from .costmodel import machine_rates

        return machine_rates(doc)
    except (TypeError, ValueError, AttributeError, KeyError):
        return {}
