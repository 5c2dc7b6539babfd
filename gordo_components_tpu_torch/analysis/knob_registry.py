"""Knob-registry checker: every ``GORDO_*`` mention must be declared.

The rule is deliberately blanket: ANY ``GORDO_*`` token embedded in a
string constant in the port's scanned tree — an ``os.environ.get``, a click
``envvar=``, a generated k8s env spec, a docstring's prose mention —
must have a :mod:`.knobs` entry. Mentions in prose are exactly how
knob docs drift, so they are held to the same registry the README's
port knob table is generated from. (``analysis/knobs.py`` itself is excluded
from the scan by the runner — its literals ARE the registry, and
counting them would make the staleness check below circular.)

The runner adds the reverse direction: a registered knob mentioned
NOWHERE is stale and flagged (``collect_mentions`` feeds it).
"""

from __future__ import annotations

import ast
import re
from typing import List, Set, Tuple

from .astscan import Module
from .findings import Finding
from .knobs import KNOBS

CHECKER = "knob-registry"

# embedded tokens, word-bounded: "set GORDO_FOO=1 to ..." in a
# docstring mentions GORDO_FOO; a dangling "GORDO_" prefix fragment
# (string concatenation in tests) is not a knob name
_KNOB_RE = re.compile(r"\bGORDO_[A-Z0-9_]*[A-Z0-9]\b")


def _mentions(module: Module) -> List[Tuple[str, ast.Constant]]:
    out = []
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for name in _KNOB_RE.findall(node.value):
                out.append((name, node))
    return out


def collect_mentions(module: Module) -> Set[str]:
    return {name for name, _ in _mentions(module)}


def check(module: Module) -> List[Finding]:
    findings: List[Finding] = []
    flagged: Set[str] = set()
    for name, node in _mentions(module):
        if name in KNOBS or name in flagged:
            continue
        flagged.add(name)  # one finding per knob per file
        findings.append(
            Finding(
                checker=CHECKER, code="unregistered-knob",
                file=module.relpath, line=node.lineno, key=name,
                message=(
                    f"{name} is not declared in analysis/knobs.py — "
                    "undeclared knobs are invisible to the generated "
                    "README table and rot undocumented"
                ),
                hint=(
                    "add a Knob entry (name, default, parser, one-line "
                    "doc) to analysis/knobs.py, then regenerate the "
                    "README table"
                ),
            )
        )
    return findings


def stale_knobs(all_mentions: Set[str]) -> List[Finding]:
    """Registered knobs no code or doc mentions any more."""
    findings = []
    for name in sorted(set(KNOBS) - all_mentions):
        findings.append(
            Finding(
                checker=CHECKER, code="stale-knob",
                file="gordo_components_tpu_torch/analysis/knobs.py", line=1,
                key=name,
                message=(
                    f"{name} is registered but mentioned nowhere in the "
                    "tree — delete the entry or the dead knob it "
                    "documents"
                ),
                hint="remove the Knob entry and regenerate the README's port "
                     "knob table",
            )
        )
    return findings
