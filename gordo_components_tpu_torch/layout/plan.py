"""The ``gordo-layout-plan/v1`` contract: validator, fingerprint, explain
(the port's copy of ``gordo_components_tpu/layout/plan.py``; a plan
either package emits validates, fingerprints and explains the same in
the other).

Dependency-free on purpose (stdlib only, no engine/server imports): the
spec journal validates plans at parse time and the reconciler validates
them at apply time, and neither may grow a heavyweight import for it.
The document shape is a CONTRACT — bump :data:`PLAN_SCHEMA` on any
breaking change; additive optional fields keep v1.

A plan carries four decisions plus their provenance:

- ``weights``   — per-worker ring weight overrides (1.0 = uniform)
- ``residency`` — per-worker resident machine sets + the expected hit
  rate the cost model predicts for them (optional ``cap`` resizes the
  megabatch residency height fleet-wide)
- ``precision`` — per-machine precision rung downgrades, chosen within
  the traffic × parity budget
- ``prefetch``  — per-worker spill-tier warm hints (non-resident but
  non-trivial machines)

``source`` records WHAT the plan was computed from (input schema,
horizon, total rps, the top machine rates) so staleness can be judged
without re-finding the original telemetry; ``cost`` records the model's
baseline-vs-plan projection so ``explain`` can say why; ``moves`` names
every machine whose primary worker changed.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List

PLAN_SCHEMA = "gordo-layout-plan/v1"

#: the decision fields hashed into the fingerprint — provenance and
#: projections (source/cost/moves/generated_t) are EXCLUDED so two plans
#: that would drive the fleet identically share a fingerprint even when
#: computed from different telemetry ticks
FINGERPRINT_FIELDS = ("workers", "weights", "residency", "precision",
                      "prefetch")

_VALID_RUNGS = ("f32", "bf16", "int8")


def plan_fingerprint(plan: Dict[str, Any]) -> str:
    """Canonical sha1 over the plan's DECISION fields (sorted-key JSON,
    no whitespace drift). This is the identity workers report back in
    ``/healthz`` and the reconciler converges on."""
    decisions = {key: plan.get(key) for key in FINGERPRINT_FIELDS}
    blob = json.dumps(decisions, sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:16]


def validate_layout_plan(doc: Any) -> List[str]:
    """Schema check for a layout plan, dependency-free. Returns a list
    of problems — empty means the document honours the v1 contract.
    Validation is STRUCTURAL only: machines or workers that no longer
    exist in the live fleet are an application-time degrade (skip), not
    a validation error — a stale-but-well-formed plan must never wedge
    the spec journal or the reconciler."""
    problems: List[str] = []

    def num(value: Any) -> bool:
        return isinstance(value, (int, float)) and not isinstance(value, bool)

    if not isinstance(doc, dict):
        return ["plan is not an object"]
    if doc.get("schema") != PLAN_SCHEMA:
        problems.append(
            f"schema: expected {PLAN_SCHEMA!r}, got {doc.get('schema')!r}"
        )
    if not isinstance(doc.get("fingerprint"), str) or not doc.get(
        "fingerprint"
    ):
        problems.append("fingerprint: missing or not a string")
    if not num(doc.get("generated_t")):
        problems.append("generated_t: missing or not a number")
    workers = doc.get("workers")
    if not isinstance(workers, list) or not all(
        isinstance(w, str) and w for w in workers
    ):
        problems.append("workers: missing or not a list of names")
        workers = []
    weights = doc.get("weights")
    if not isinstance(weights, dict):
        problems.append("weights: missing or not a map")
    else:
        for worker, weight in weights.items():
            if not num(weight) or weight <= 0:
                problems.append(f"weights[{worker}]: not a positive number")
    residency = doc.get("residency")
    if not isinstance(residency, dict):
        problems.append("residency: missing or not an object")
    else:
        cap = residency.get("cap")
        if cap is not None and (not num(cap) or cap < 0):
            problems.append("residency.cap: not a non-negative number")
        per_worker = residency.get("workers")
        if not isinstance(per_worker, dict):
            problems.append("residency.workers: missing or not a map")
        else:
            for worker, entry in per_worker.items():
                if not isinstance(entry, dict):
                    problems.append(
                        f"residency.workers[{worker}]: not an object"
                    )
                    continue
                resident = entry.get("resident")
                if not isinstance(resident, list) or not all(
                    isinstance(m, str) for m in resident
                ):
                    problems.append(
                        f"residency.workers[{worker}].resident: not a list "
                        "of machine names"
                    )
                hit = entry.get("expected_hit_rate")
                if hit is not None and (not num(hit) or not 0 <= hit <= 1):
                    problems.append(
                        f"residency.workers[{worker}].expected_hit_rate: "
                        "not in [0, 1]"
                    )
    precision = doc.get("precision")
    if not isinstance(precision, dict):
        problems.append("precision: missing or not a map")
    else:
        for machine, rung in precision.items():
            if rung not in _VALID_RUNGS:
                problems.append(
                    f"precision[{machine}]: {rung!r} is not one of "
                    f"{_VALID_RUNGS}"
                )
    prefetch = doc.get("prefetch")
    if not isinstance(prefetch, dict):
        problems.append("prefetch: missing or not a map")
    else:
        for worker, names in prefetch.items():
            if not isinstance(names, list) or not all(
                isinstance(m, str) for m in names
            ):
                problems.append(
                    f"prefetch[{worker}]: not a list of machine names"
                )
    source = doc.get("source")
    if source is not None and not isinstance(source, dict):
        problems.append("source: not an object")
    if not problems and isinstance(doc.get("fingerprint"), str):
        expected = plan_fingerprint(doc)
        if doc["fingerprint"] != expected:
            problems.append(
                f"fingerprint: {doc['fingerprint']!r} does not match the "
                f"decision fields (expected {expected!r}) — plan was edited "
                "after emission"
            )
    return problems


def explain_plan(plan: Dict[str, Any]) -> str:
    """Human rendering of a plan: what was decided, from what evidence,
    and WHY each machine moved. Pure function of the plan document —
    works offline on a saved artifact."""
    lines: List[str] = []
    source = plan.get("source") or {}
    lines.append(
        f"layout plan {plan.get('fingerprint', '?')} "
        f"(schema {plan.get('schema', '?')})"
    )
    lines.append(
        f"  computed over horizon {source.get('horizon', '?')} "
        f"({source.get('total_rps', 0.0):.1f} rps total, "
        f"{len(source.get('rates') or {})} machines measured)"
    )
    cost = plan.get("cost") or {}
    baseline, projected = cost.get("baseline") or {}, cost.get("plan") or {}
    if baseline and projected:
        lines.append(
            "  cost: load imbalance {:.2f} -> {:.2f}, expected hit rate "
            "{:.0%} -> {:.0%}, machines/GiB {:.1f} -> {:.1f}".format(
                baseline.get("imbalance", 0.0),
                projected.get("imbalance", 0.0),
                baseline.get("expected_hit_rate", 0.0),
                projected.get("expected_hit_rate", 0.0),
                baseline.get("machines_per_gib", 0.0),
                projected.get("machines_per_gib", 0.0),
            )
        )
    weights = plan.get("weights") or {}
    if weights:
        rendered = ", ".join(
            f"{worker}={weight:g}" for worker, weight in sorted(
                weights.items()
            )
        )
        lines.append(f"  ring weights: {rendered}")
    else:
        lines.append("  ring weights: uniform (no overrides)")
    residency = (plan.get("residency") or {}).get("workers") or {}
    for worker in sorted(residency):
        entry = residency[worker] or {}
        resident = entry.get("resident") or []
        hit = entry.get("expected_hit_rate")
        lines.append(
            f"  {worker}: {len(resident)} resident"
            + (f" (expected hit rate {hit:.0%})" if hit is not None else "")
            + (": " + ", ".join(resident[:6]) if resident else "")
            + (" ..." if len(resident) > 6 else "")
        )
    precision = plan.get("precision") or {}
    if precision:
        for machine in sorted(precision):
            lines.append(f"  precision: {machine} -> {precision[machine]}")
    moves = plan.get("moves") or []
    if moves:
        lines.append(f"  {len(moves)} machine(s) moved:")
        for move in moves:
            lines.append(
                f"    {move.get('machine')}: {move.get('from', '?')} -> "
                f"{move.get('to', '?')} ({move.get('reason', 'rebalance')})"
            )
    else:
        lines.append("  no machines moved")
    return "\n".join(lines)
