"""Span-seam checker: thread/asyncio handoffs must carry SpanContext.

A trace-loss bug class: work handed to another thread
(``threading.Thread(target=...)``, ``executor.submit(...)``,
``loop.call_soon_threadsafe(...)``, ``run_coroutine_threadsafe(...)``)
inherits NO contextvars, so spans recorded and log lines emitted on the
far side silently lose their timeline and ``X-Gordo-Trace-Id`` unless
the seam explicitly captures and re-binds a ``SpanContext``
(``spans.capture()`` at enqueue, ``spans.bind()`` /
``spans.record_into()`` on the far side). This checker keeps the
class fixed.

Rule: for every seam call whose target resolves to a function in the
same module, if the target's body (or, one level down, a same-module
callee's body) records spans or logs, then there must be binding
evidence — ``spans.bind`` / ``record_into`` / ``event_into`` in the
target's reachable bodies, or a ``spans.capture()`` in the enqueuing
function. Targets that neither record nor log (pure plumbing like a
server ``shutdown``) pass; unresolvable targets (callables from other
modules) are skipped rather than guessed at.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from .astscan import Module, dotted, iter_calls, resolve_target
from .findings import Finding

CHECKER = "span-seam"

# seams where contextvars are lost
_SEAM_ATTRS = frozenset(
    {"submit", "call_soon_threadsafe", "run_coroutine_threadsafe"}
)
_BIND_EVIDENCE = ("bind", "record_into", "event_into")
_RECORD_ATTRS = frozenset({"stage", "event", "begin", "record_into",
                           "event_into", "add_span", "add_event"})
_LOG_METHODS = frozenset(
    {"debug", "info", "warning", "error", "exception", "critical", "log"}
)


def _seam_target(call: ast.Call) -> Optional[ast.AST]:
    """The callable expression a seam call hands across threads, or
    None when this call is not a seam."""
    name = dotted(call.func)
    if not name:
        return None
    last = name.split(".")[-1]
    if last == "Thread" or name.endswith("threading.Thread"):
        for keyword in call.keywords:
            if keyword.arg == "target":
                return keyword.value
        return None
    if last in _SEAM_ATTRS and call.args:
        # executor.submit(fn, ...), loop.call_soon_threadsafe(fn),
        # asyncio.run_coroutine_threadsafe(coro_call, loop)
        if last == "submit" and _looks_like_queue_put(name):
            return None
        return call.args[0]
    return None


def _looks_like_queue_put(name: str) -> bool:
    # ``prefetcher.submit`` on an executor IS a seam; guard only against
    # obvious non-executor ``submit`` like the engine's bucket.submit —
    # whose receiver is a bucket, not a pool/executor.
    chain = [part.lower() for part in name.split(".")[:-1]]
    return any("bucket" in part or "engine" in part for part in chain)


def _records_spans(node: ast.AST) -> Optional[int]:
    for call in iter_calls(node):
        name = dotted(call.func)
        if not name:
            continue
        parts = name.split(".")
        if len(parts) >= 2 and parts[-2] == "spans" and (
            parts[-1] in _RECORD_ATTRS
        ):
            return call.lineno
    return None


def _logs(node: ast.AST) -> Optional[int]:
    for call in iter_calls(node):
        name = dotted(call.func)
        if not name:
            continue
        parts = name.split(".")
        if len(parts) >= 2 and parts[-1] in _LOG_METHODS and (
            "logger" in parts[-2] or parts[-2] == "logging"
        ):
            return call.lineno
    return None


def _has_bind_evidence(node: ast.AST) -> bool:
    for call in iter_calls(node):
        name = dotted(call.func)
        if not name:
            continue
        parts = name.split(".")
        if parts[-1] in _BIND_EVIDENCE:
            return True
    return False


def _has_capture(node: ast.AST) -> bool:
    for call in iter_calls(node):
        name = dotted(call.func)
        if name and name.split(".")[-1] == "capture":
            return True
    return False


def _reachable_bodies(module: Module, target: ast.AST) -> List[ast.AST]:
    """The target body plus one level of same-module callees."""
    bodies = [target]
    for call in iter_calls(target):
        name = dotted(call.func)
        if not name:
            continue
        parts = name.split(".")
        # sound resolution only: bare names and self.method (see _resolve)
        if len(parts) > 2 or (len(parts) == 2 and parts[0] != "self"):
            continue
        callee = module.functions.get(parts[-1])
        if callee is not None and callee is not target:
            bodies.append(callee)
    return bodies


def _own_calls(scope: ast.AST) -> List[ast.Call]:
    """Calls at this scope's own level — nested function bodies are
    their own scopes and must not be re-reported here."""
    nested: Set[int] = set()
    for sub in ast.walk(scope):
        if sub is scope:
            continue
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            for inner in ast.walk(sub):
                nested.add(id(inner))
    return [
        call for call in iter_calls(scope) if id(call) not in nested
    ]


def check(module: Module) -> List[Finding]:
    findings: List[Finding] = []
    scopes: List[ast.AST] = [module.tree]
    seen: Set[int] = set()
    for node in ast.walk(module.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if id(node) not in seen:
                seen.add(id(node))
                scopes.append(node)
    for scope in scopes:
        scope_name = getattr(scope, "name", "<module>")
        for call in _own_calls(scope):
            target_expr = _seam_target(call)
            if target_expr is None:
                continue
            target_name, target_node = resolve_target(
                module, scope, target_expr
            )
            if target_node is None:
                continue  # external callable; nothing to inspect
            bodies = _reachable_bodies(module, target_node)
            span_line = next(
                (line for line in map(_records_spans, bodies)
                 if line is not None), None,
            )
            log_line = next(
                (line for line in map(_logs, bodies) if line is not None),
                None,
            )
            if span_line is None and log_line is None:
                continue  # pure plumbing: no observability on the far side
            if any(_has_bind_evidence(body) for body in bodies):
                continue
            if _has_capture(scope):
                continue  # enqueue-side capture: ctx handed along explicitly
            what = []
            if span_line is not None:
                what.append(f"records spans (line {span_line})")
            if log_line is not None:
                what.append(f"logs (line {log_line})")
            findings.append(
                Finding(
                    checker=CHECKER, code="unbound-seam",
                    file=module.relpath, line=call.lineno,
                    key=f"{scope_name}:{target_name}",
                    message=(
                        f"{target_name!r} crosses a thread/asyncio seam "
                        f"and {' and '.join(what)} without binding a "
                        "SpanContext — its spans and log records lose "
                        "the request's trace id"
                    ),
                    hint=(
                        "capture ctx = spans.capture() at the enqueue "
                        "site and wrap the far side in spans.bind(ctx) "
                        "(or record via spans.record_into/event_into)"
                    ),
                )
            )
    return findings
