"""Metrics-conventions checker: the port's metric contract,
machine-checked.

Grammar: every registry metric is ``gordo_<component>_<noun>[_<unit>]``
where ``<component>`` is one of the known layers; counters MUST end in
``_total``; histograms MUST end in an explicit unit (``_seconds``,
``_bytes``, or a declared dimensionless unit like ``_size``); gauges are
current-state nouns and must NOT carry ``_total``/``_seconds``. Labels
come from the allowlist — low-cardinality enums, never request data —
and label VALUES built from f-strings/concatenation are flagged as
unbounded-cardinality.

The grammar is exported for reuse as :func:`check_name` /
:func:`check_family_name` (exposition family names, histogram suffixes
stripped).
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Tuple

from .astscan import Module, dotted, iter_calls
from .findings import Finding

CHECKER = "metrics-conventions"

# the known layers of the port a metric may belong to (longest-prefix
# matched, so ``compile_cache`` wins over a hypothetical ``compile``)
COMPONENTS = (
    "server", "engine", "client", "build", "builds", "fleet", "watchman",
    "router", "resilience", "store", "compile_cache", "span", "stage",
    "slo", "autopilot", "mesh", "telemetry", "tenant", "incident",
)

# the port's label allowlist: low-cardinality enums only. ``machine``/
# ``worker`` are bounded by fleet/tier size — the documented exceptions
# (``machine`` is further capped at render time, registry.py).
# ``window`` is the two-value fast/slow burn-rate window enum.
# ``precision`` is the three-value f32/bf16/int8 ladder enum.
# ``actuator``/``direction`` are the autopilot's decision enums.
# ``tenant`` is bounded by the DECLARED tenant table — unknown header
# values fold into 'default' before any label is minted — and ``class``
# is the three-value interactive/standard/bulk enum.
# ``actor`` is the control ledger's closed writer enum — unknown actors
# fold into 'operator' before the label is minted.
# ``shard`` is bounded by the serving mesh's declared shard count.
ALLOWED_LABELS = frozenset(
    {
        "endpoint", "status", "kind", "outcome", "path", "event", "phase",
        "reason", "stage", "name", "trigger", "format", "worker",
        "machine", "cause", "point", "to", "where", "error",
        "window", "precision", "actuator", "direction",
        "tenant", "class", "actor", "shard",
    }
)

# histogram unit suffixes: real units first, declared dimensionless
# units after (counts of things per observation window)
HIST_UNITS = (
    "seconds", "bytes", "size", "requests", "machines", "occupancy",
)

_NAME_RE = re.compile(r"^gordo(_[a-z0-9]+)+$")
_EXPOSITION_SUFFIXES = ("_bucket", "_count", "_sum")


def component_of(name: str) -> Optional[str]:
    rest = name[len("gordo_"):]
    best = None
    for component in COMPONENTS:
        if rest == component or rest.startswith(component + "_"):
            if best is None or len(component) > len(best):
                best = component
    return best


def check_name(name: str, kind: str) -> Optional[str]:
    """One metric name against the grammar; an error message or None.
    ``kind`` in counter/gauge/histogram — or 'family' for exposition
    names whose kind is unknown (grammar + component only)."""
    if not _NAME_RE.match(name):
        return (
            f"{name!r} is not gordo_<component>_<noun> "
            "(lower_snake_case, gordo_ prefix)"
        )
    if component_of(name) is None:
        return (
            f"{name!r} names no known component "
            f"(expected one of {', '.join(COMPONENTS)} after gordo_)"
        )
    if kind == "counter" and not name.endswith("_total"):
        return f"counter {name!r} must end in _total"
    if kind == "histogram" and not any(
        name.endswith("_" + unit) for unit in HIST_UNITS
    ):
        return (
            f"histogram {name!r} must end in an explicit unit "
            f"({', '.join('_' + u for u in HIST_UNITS)})"
        )
    if kind == "gauge" and name.endswith("_total"):
        return (
            f"gauge {name!r} ends in _total — that suffix is reserved "
            "for counters (gauges may carry unit suffixes like _seconds)"
        )
    return None


def check_family_name(name: str) -> Optional[str]:
    """Exposition-side validation (scrape_metrics): family names with
    the histogram suffixes stripped must still fit the grammar."""
    base = name
    for suffix in _EXPOSITION_SUFFIXES:
        if base.endswith(suffix):
            base = base[: -len(suffix)]
            break
    return check_name(base, "family")


_METRIC_FACTORIES = {"counter": "counter", "gauge": "gauge",
                     "histogram": "histogram"}


def _registry_call(call: ast.Call) -> Optional[str]:
    """'counter'/'gauge'/'histogram' when this is a registry metric
    declaration (receiver named REGISTRY/registry/self.registry)."""
    name = dotted(call.func)
    if not name:
        return None
    parts = name.split(".")
    if len(parts) < 2 or parts[-1] not in _METRIC_FACTORIES:
        return None
    receiver = parts[-2].lower()
    if receiver in ("registry", "_registry"):
        return parts[-1]
    return None


def _literal_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _unbounded_value(node: ast.AST) -> bool:
    """Statically-unbounded label value: built per call site from
    runtime data (f-string, %-format, .format, concatenation)."""
    if isinstance(node, ast.JoinedStr):
        return any(
            isinstance(part, ast.FormattedValue) for part in node.values
        )
    if isinstance(node, ast.BinOp) and isinstance(
        node.op, (ast.Add, ast.Mod)
    ):
        return True
    if isinstance(node, ast.Call):
        name = dotted(node.func)
        return bool(name) and name.split(".")[-1] == "format"
    return False


def check(module: Module) -> List[Finding]:
    findings: List[Finding] = []
    for call in iter_calls(module.tree):
        kind = _registry_call(call)
        if kind is not None:
            findings.extend(_check_declaration(module, call, kind))
            continue
        name = dotted(call.func)
        if name and name.split(".")[-1] == "labels":
            for position, arg in enumerate(call.args):
                if _unbounded_value(arg):
                    findings.append(
                        Finding(
                            checker=CHECKER, code="unbounded-label-value",
                            file=module.relpath, line=call.lineno,
                            key=f"{name}:{position}",
                            message=(
                                "label value is built from runtime data "
                                "(f-string/format/concat) — unbounded "
                                "series cardinality"
                            ),
                            hint=(
                                "label with a closed enum and put the "
                                "variable part in the log/trace instead"
                            ),
                        )
                    )
    return findings


def _check_declaration(
    module: Module, call: ast.Call, kind: str
) -> List[Finding]:
    findings: List[Finding] = []
    name = _literal_str(call.args[0]) if call.args else None
    if name is None:
        for keyword in call.keywords:
            if keyword.arg == "name":
                name = _literal_str(keyword.value)
    if name is None:
        return findings  # dynamic name: tests build these; not a contract
    error = check_name(name, kind)
    if error is not None:
        findings.append(
            Finding(
                checker=CHECKER, code="bad-metric-name",
                file=module.relpath, line=call.lineno, key=name,
                message=error,
                hint="gordo_<component>_<noun>[_<unit>]; see COMPONENTS in "
                     "analysis/metrics_conventions.py",
            )
        )
    labels = _declared_labels(call)
    for label in labels or ():
        if label not in ALLOWED_LABELS:
            findings.append(
                Finding(
                    checker=CHECKER, code="unknown-label",
                    file=module.relpath, line=call.lineno,
                    key=f"{name}:{label}",
                    message=(
                        f"label {label!r} on {name!r} is not in the "
                        "label allowlist"
                    ),
                    hint=(
                        "use an existing label name, or extend "
                        "ALLOWED_LABELS in analysis/metrics_conventions.py "
                        "with a note on its bound"
                    ),
                )
            )
    return findings


def _declared_labels(call: ast.Call) -> Optional[Tuple[str, ...]]:
    node = None
    for keyword in call.keywords:
        if keyword.arg in ("labels", "labelnames"):
            node = keyword.value
    if node is None:
        return None
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for element in node.elts:
            text = _literal_str(element)
            if text is None:
                return None
            out.append(text)
        return tuple(out)
    return None
