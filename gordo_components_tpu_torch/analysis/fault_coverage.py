"""Fault-seam coverage checker: chaos coverage cannot silently rot.

The port's ``resilience/faults.py`` declares the injection points
(``POINTS``) and production code wires them with ``inject(point, ...)``
/ ``corrupt`` / ``damage_artifact`` calls. The port's tests, tools and
``chip_smoke.py`` exercise them through spec strings
(``point:target:kind``) and direct calls (the runner scans no test of
the reference: its coverage is not the port's) —
but nothing ever checked that EVERY declared seam is still exercised:
delete the one test that injects at ``data-fetch`` and the seam keeps
existing, untested, forever.

Statically cross-referenced, three directions:

- ``uncovered-fault-seam`` — a declared point no test or smoke tool
  references (spec-string first segment, or a literal ``inject``/
  ``configure``/``parse_spec`` argument under ``tests/``/``tools/``).
- ``unwired-fault-point``  — declared but no production call site
  injects at it: a seam that cannot fire.
- ``undeclared-fault-point`` — a production ``inject(...)`` literal
  not in ``POINTS``: it can never match a rule, so it silently
  injects nothing.

Evidence collected per file by :func:`scan`, joined by :func:`finalize`.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

from .astscan import CARD_SCRIPTS, Module, dotted
from .findings import Finding

CHECKER = "fault-coverage"

FAULTS_RELPATH = "gordo_components_tpu_torch/resilience/faults.py"

_SEAM_CALLS = frozenset({"inject", "corrupt", "damage_artifact"})
_SPEC_CALLS = frozenset({"configure", "parse_spec"})
# a spec rule chunk: point:target:kind[:param]
_SPEC_RULE_RE = re.compile(
    r"([a-z][a-z0-9-]*):([^:;\s]+):([a-z][a-z0-9-]*)"
)


@dataclass
class FaultEvidence:
    relpath: str = ""
    # POINTS entries (faults.py only): name -> line
    declared: Dict[str, int] = field(default_factory=dict)
    # production inject/corrupt/damage_artifact literal points
    wired: Dict[str, int] = field(default_factory=dict)
    # test/tool references (direct-call args + spec-string points)
    referenced: Set[str] = field(default_factory=set)


def scan(module: Module) -> FaultEvidence:
    evidence = FaultEvidence(relpath=module.relpath)
    is_faults = module.relpath.endswith("resilience/faults.py")
    is_exerciser = module.relpath.startswith(("tests/", "tools/")) or (
        module.relpath in CARD_SCRIPTS
    )

    if is_faults:
        for node in module.tree.body:
            if (
                isinstance(node, ast.Assign)
                and any(
                    isinstance(t, ast.Name) and t.id == "POINTS"
                    for t in node.targets
                )
                and isinstance(node.value, (ast.Tuple, ast.List))
            ):
                for element in node.value.elts:
                    if isinstance(element, ast.Constant) and isinstance(
                        element.value, str
                    ):
                        evidence.declared[element.value] = element.lineno
        return evidence  # its own docstring examples are not coverage

    # docstrings are prose, not coverage: a seam spec MENTIONED in a
    # test's docstring must not keep the seam counted as exercised
    docstrings: Set[int] = set()
    for node in ast.walk(module.tree):
        if isinstance(
            node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                   ast.AsyncFunctionDef)
        ):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                body[0].value, ast.Constant
            ) and isinstance(body[0].value.value, str):
                docstrings.add(id(body[0].value))

    for node in ast.walk(module.tree):
        if isinstance(node, ast.Call):
            name = dotted(node.func)
            last = name.split(".")[-1] if name else ""
            if last in _SEAM_CALLS and node.args:
                literal = node.args[0]
                if isinstance(literal, ast.Constant) and isinstance(
                    literal.value, str
                ):
                    if is_exerciser:
                        evidence.referenced.add(literal.value)
                    else:
                        evidence.wired.setdefault(
                            literal.value, literal.lineno
                        )
            if is_exerciser and last in _SPEC_CALLS and node.args:
                literal = node.args[0]
                if isinstance(literal, ast.Constant) and isinstance(
                    literal.value, str
                ):
                    for match in _SPEC_RULE_RE.finditer(literal.value):
                        evidence.referenced.add(match.group(1))
        if is_exerciser and isinstance(node, ast.Constant) and isinstance(
            node.value, str
        ) and id(node) not in docstrings:
            # spec strings travel as env values / CLI flags too
            for match in _SPEC_RULE_RE.finditer(node.value):
                evidence.referenced.add(match.group(1))
    return evidence


def finalize(evidences: List[FaultEvidence]) -> List[Finding]:
    declared: Dict[str, int] = {}
    wired: Dict[str, Tuple[str, int]] = {}
    referenced: Set[str] = set()
    for evidence in evidences:
        declared.update(evidence.declared)
        for point, line in evidence.wired.items():
            wired.setdefault(point, (evidence.relpath, line))
        referenced |= evidence.referenced

    findings: List[Finding] = []
    if not declared:
        return findings  # faults.py outside the scanned set (corpus runs)
    for point, line in sorted(declared.items()):
        if point not in referenced:
            findings.append(
                Finding(
                    checker=CHECKER, code="uncovered-fault-seam",
                    file=FAULTS_RELPATH, line=line, key=point,
                    message=(
                        f"injection point {point!r} is exercised by no "
                        "test or smoke tool — its chaos coverage rotted"
                    ),
                    hint=(
                        "add a test/smoke spec that injects at this "
                        "seam, or delete the point"
                    ),
                )
            )
        if point not in wired:
            findings.append(
                Finding(
                    checker=CHECKER, code="unwired-fault-point",
                    file=FAULTS_RELPATH, line=line, key=point,
                    message=(
                        f"injection point {point!r} has no production "
                        "inject()/corrupt()/damage_artifact() call site "
                        "— the seam can never fire"
                    ),
                    hint="wire the boundary, or delete the point",
                )
            )
    for point, (relpath, line) in sorted(wired.items()):
        if point not in declared:
            findings.append(
                Finding(
                    checker=CHECKER, code="undeclared-fault-point",
                    file=relpath, line=line, key=point,
                    message=(
                        f"inject point {point!r} is not in faults.POINTS "
                        "— no spec can ever match it, so it silently "
                        "injects nothing"
                    ),
                    hint="add it to POINTS (and the spec-grammar doc), "
                         "or fix the typo",
                )
            )
    return findings
