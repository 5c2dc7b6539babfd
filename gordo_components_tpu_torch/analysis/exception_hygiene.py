"""Exception-hygiene checker: no silent broad swallows.

A ``except Exception: pass`` (or bare ``except:``) that neither logs
nor publishes a counter erases evidence — the resilience layers
exist precisely so failures surface as ``gordo_resilience_*`` /
component series instead of vanishing. This checker flags broad
handlers whose body is INERT: no call at all (so no logger, no metric,
no cleanup), no ``raise``. A handler that calls anything is presumed to
be handling (cleanup counts as handling; the narrow-exception form is
always fine) — the rule targets the pure swallow.

Escape hatch: ``# lint: allow-swallow(<reason>)`` on the ``except``
line; the reason is mandatory.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .astscan import Module
from .findings import Finding

CHECKER = "exception-hygiene"

_BROAD = frozenset({"Exception", "BaseException"})


def _broad_catch(handler: ast.ExceptHandler) -> Optional[str]:
    """'bare'/'Exception'/'BaseException' when the handler catches
    everything, else None."""
    node = handler.type
    if node is None:
        return "bare"
    candidates = node.elts if isinstance(node, ast.Tuple) else [node]
    for candidate in candidates:
        if isinstance(candidate, ast.Name) and candidate.id in _BROAD:
            return candidate.id
    return None


def _inert(handler: ast.ExceptHandler) -> bool:
    """True when the handler body does nothing observable: no call, no
    raise, and no use of the bound exception (``except ... as exc:``
    bodies that store ``exc`` somewhere propagate the error by value —
    the engine's ``it.error = exc`` fan-out — which is handling, not
    swallowing)."""
    for stmt in handler.body:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Raise, ast.Call)):
                return False
            if (
                handler.name
                and isinstance(node, ast.Name)
                and node.id == handler.name
                and isinstance(node.ctx, ast.Load)
            ):
                return False
    return True


def check(module: Module) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        breadth = _broad_catch(node)
        if breadth is None or not _inert(node):
            continue
        suppression = module.allows("swallow", node.lineno)
        if suppression is not None:
            if not suppression.reason:
                findings.append(
                    Finding(
                        checker=CHECKER, code="empty-escape-reason",
                        file=module.relpath, line=node.lineno,
                        key=f"L{node.lineno}",
                        message=(
                            "allow-swallow escape hatch carries no "
                            "reason — the reason is the contract"
                        ),
                        hint="write # lint: allow-swallow(<why silence "
                             "is correct here>)",
                    )
                )
            continue
        label = "except:" if breadth == "bare" else f"except {breadth}:"
        scope = _enclosing_function(module, node)
        findings.append(
            Finding(
                checker=CHECKER, code="counterless-swallow",
                file=module.relpath, line=node.lineno,
                key=f"{scope}:{breadth}",
                message=(
                    f"{label} swallows every error without logging or "
                    "publishing a counter — failures here leave no "
                    "evidence in logs or gordo_* series"
                ),
                hint=(
                    "log it, count it (e.g. a gordo_<component>_*_total "
                    "outcome label), narrow the except, or annotate with "
                    "# lint: allow-swallow(<reason>)"
                ),
            )
        )
    return findings


def _enclosing_function(module: Module, target: ast.AST) -> str:
    """Innermost function containing ``target`` (key stability: line
    numbers move, scope names rarely do)."""
    best = "<module>"
    best_size = None
    for node in ast.walk(module.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if (
                node.lineno <= target.lineno
                and target.lineno <= (node.end_lineno or node.lineno)
            ):
                size = (node.end_lineno or node.lineno) - node.lineno
                if best_size is None or size < best_size:
                    best = node.name
                    best_size = size
    return best
