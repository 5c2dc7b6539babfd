"""Static lock-discipline checker.

Two rules over the declared hierarchy in :mod:`.locks`:

1. **lock-order-inversion** — a ``with`` over a known lock while
   already (lexically) holding a lock of equal or higher rank. The
   analysis is intra-procedural over ``with``-statements: that is
   where every hot-path acquisition in this codebase lives
   (``acquire()``-style critical sections exist only on the admin
   paths; the runtime validator — :mod:`.lockcheck` — covers those
   and every cross-function composition the static walk cannot see).

2. **blocking-under-lock** — a blocking call (a wait for the device,
   HTTP, parameterless ``.join()``, ``sleep``, a kernel library's build
   or load) made while a HOT lock is held, including one level into
   same-module callees (the collector-handover join hides behind a
   method call). Escape hatch: ``# lint: allow-blocking(<reason>)`` on
   the flagged line; the reason is mandatory.

``Condition.wait`` is deliberately NOT a blocking call: waiting
releases the lock — that is the one blocking thing a condition is for.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .astscan import (
    Module,
    attr_chain_names,
    dotted,
    iter_calls,
    resolve_target,
)
from .findings import Finding
from .locks import HOT_LOCKS, LOCK_ATTRS, LOCK_RANKS

CHECKER = "lock-discipline"

_HTTP_VERBS = frozenset(
    {"get", "post", "put", "delete", "head", "request", "send",
     "getresponse", "urlopen"}
)
# what marks a receiver chain as the port's HTTP: utils/http.py's pooled
# Session (``self._session.post``, ``http.get``) and ``http.client``'s
# connections (``conn.getresponse``)
_HTTP_RECEIVERS = ("session", "http", "conn", "urllib")

# a wait for the device: CUDA synchronization, and reading a tensor's
# value on the host (``.item()``, ``.cpu()``; ``.tolist()`` only on a
# chain that shows a tensor, since numpy arrays have one too)
_DEVICE_SYNC = frozenset({"synchronize"})
_DEVICE_READ = frozenset({"item", "cpu"})
_TENSOR_METHODS = frozenset({"detach", "cpu", "cuda", "to"})

# a kernel library's build or load (ops/_kernels.py): the first launch's
# resolve, the store fill, and the nvcc run behind them
_KERNEL_BUILDS = frozenset(
    {"_library", "fill_store", "_resolve_locked", "_build_into"}
)
_SUBPROCESS_CALLS = frozenset(
    {"run", "Popen", "call", "check_call", "check_output"}
)


def _lock_map_for(relpath: str) -> Dict[str, str]:
    """attribute name -> lock name, for the file being scanned."""
    out: Dict[str, str] = {}
    for (suffix, attr), name in LOCK_ATTRS.items():
        if relpath.endswith(suffix):
            out[attr] = name
    return out


def _runs_nvcc(call: ast.Call) -> bool:
    """A subprocess call whose command names ``nvcc``."""
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                if "nvcc" in sub.value:
                    return True
            elif isinstance(sub, (ast.Name, ast.Attribute)):
                if "nvcc" in dotted(sub).lower():
                    return True
    return False


def _blocking_reason(call: ast.Call) -> Optional[str]:
    """Why this call blocks, or None. Vocabulary: waits for the device,
    HTTP, joins, sleeps, a kernel library's build or load."""
    name = dotted(call.func)
    if not name:
        return None
    last = name.split(".")[-1]
    parts = name.split(".")
    chain = [p.lower().rstrip("()") for p in parts[:-1]]
    if last in _DEVICE_SYNC and len(parts) > 1:
        return f"{name} blocks on device completion"
    if last in _DEVICE_READ and len(parts) > 1 and not call.args:
        if chain[0] not in ("np", "numpy"):
            return f"{name} blocks on device completion"
    if last == "tolist" and len(parts) > 1 and any(
        part in _TENSOR_METHODS or "torch" in part or "tensor" in part
        for part in chain
    ):
        return f"{name} blocks on device completion"
    if last in _KERNEL_BUILDS or (
        last == "resolve" and any("kernels" in part for part in chain)
    ):
        return f"{name} pays a kernel library build or load"
    if last in _SUBPROCESS_CALLS and "subprocess" in chain and _runs_nvcc(call):
        return f"{name} pays an nvcc compile"
    if last == "sleep":
        return f"{name} sleeps"
    if last == "join" and not call.args:
        # Queue.join()/Thread.join(): parameterless (or timeout-kwarg)
        # joins block; ``", ".join(parts)`` always has a positional arg
        return f"{name}() joins"
    if last in _HTTP_VERBS and len(parts) > 1:
        if any(marker in part for part in chain for marker in _HTTP_RECEIVERS):
            return f"{name} performs network I/O"
    return None


def _is_function(node: ast.AST) -> bool:
    return isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))


class _Scope:
    def __init__(self, module: Module, lock_map: Dict[str, str],
                 scope_name: str, scope_node: ast.AST,
                 findings: List[Finding]):
        self.module = module
        self.lock_map = lock_map
        self.scope_name = scope_name
        self.scope_node = scope_node
        self.findings = findings
        self.held: List[str] = []

    # -- rule 2 ---------------------------------------------------------------
    def _flag_blocking(self, node: ast.AST, line: int, why: str,
                       key_extra: str, via: str = "") -> None:
        hot_held = [name for name in self.held if name in HOT_LOCKS]
        if not hot_held:
            return
        suppression = self.module.allows("blocking", line)
        if suppression is not None:
            if not suppression.reason:
                self.findings.append(
                    Finding(
                        checker=CHECKER, code="empty-escape-reason",
                        file=self.module.relpath, line=line,
                        key=f"{self.scope_name}:{key_extra}",
                        message=(
                            "allow-blocking escape hatch carries no "
                            "reason — the reason is the contract"
                        ),
                        hint="write # lint: allow-blocking(<why it is safe>)",
                    )
                )
            return
        lock = hot_held[-1]
        detail = f" (reached via {via})" if via else ""
        self.findings.append(
            Finding(
                checker=CHECKER, code="blocking-under-lock",
                file=self.module.relpath, line=line,
                key=f"{lock}:{self.scope_name}:{key_extra}",
                message=(
                    f"{why} while holding hot lock {lock!r}{detail} — "
                    "live requests stall behind this"
                ),
                hint=(
                    "move the call outside the lock, or annotate the "
                    "line with # lint: allow-blocking(<reason>)"
                ),
            )
        )

    def _check_call(self, call: ast.Call) -> None:
        why = _blocking_reason(call)
        if why is not None:
            self._flag_blocking(
                call, call.lineno, why, key_extra=dotted(call.func)
            )
            return
        # one level into same-module callees: a blocking call hidden
        # behind ``self._ensure_collector()`` still runs under our lock
        # (same sound bare-name/self.method resolution as span_seam)
        name, node = resolve_target(self.module, self.scope_node, call.func)
        if node is None or not _is_function(node):
            return
        for inner in iter_calls(node):
            if _within_nested_function(node, inner):
                continue
            inner_why = _blocking_reason(inner)
            if inner_why is not None:
                self._flag_blocking(
                    call, call.lineno, inner_why,
                    key_extra=f"{name}:{dotted(inner.func)}",
                    via=f"{name}() at line {inner.lineno}",
                )

    # -- walk -----------------------------------------------------------------
    def visit(self, node: ast.AST) -> None:
        if _is_function(node):
            return  # separate scope; analyzed on its own with no locks held
        if isinstance(node, (ast.With, ast.AsyncWith)):
            # items acquire LEFT TO RIGHT, so each is pushed before the
            # next is checked — ``with a, b:`` must flag a→b inversions
            # exactly like the nested form. Context expressions that are
            # CALLS (``with session.post(url):``) evaluate under every
            # lock already held, so they get the blocking check too.
            pushed = 0
            for item in node.items:
                for sub in ast.walk(item.context_expr):
                    if isinstance(sub, ast.Call):
                        self._check_call(sub)
                lock = self._resolve_lock(item.context_expr)
                if lock is not None:
                    self._check_order(lock, node.lineno)
                    self.held.append(lock)
                    pushed += 1
            try:
                for child in node.body:
                    self.visit(child)
            finally:
                if pushed:
                    del self.held[-pushed:]
            return
        if isinstance(node, ast.Call):
            self._check_call(node)
        for child in ast.iter_child_nodes(node):
            self.visit(child)

    def _resolve_lock(self, expr: ast.AST) -> Optional[str]:
        for name in attr_chain_names(expr):
            lock = self.lock_map.get(name)
            if lock is not None:
                return lock
        return None

    # -- rule 1 ---------------------------------------------------------------
    def _check_order(self, inner: str, line: int) -> None:
        for outer in self.held:
            if LOCK_RANKS[inner] <= LOCK_RANKS[outer]:
                self.findings.append(
                    Finding(
                        checker=CHECKER, code="lock-order-inversion",
                        file=self.module.relpath, line=line,
                        key=f"{outer}->{inner}:{self.scope_name}",
                        message=(
                            f"acquires {inner!r} (rank "
                            f"{LOCK_RANKS[inner]}) while holding "
                            f"{outer!r} (rank {LOCK_RANKS[outer]}); the "
                            "declared order is strictly rank-increasing"
                        ),
                        hint=(
                            "release the outer lock first, or re-rank in "
                            "analysis/locks.py with a written reason"
                        ),
                    )
                )


def _within_nested_function(scope: ast.AST, node: ast.AST) -> bool:
    """True when ``node`` sits inside a function nested under ``scope``
    (it runs later, not under the caller's locks)."""
    for sub in ast.walk(scope):
        if _is_function(sub) and sub is not scope:
            for inner in ast.walk(sub):
                if inner is node:
                    return True
    return False


def check(module: Module) -> List[Finding]:
    lock_map = _lock_map_for(module.relpath)
    if not lock_map:
        return []
    findings: List[Finding] = []
    scopes: List[Tuple[str, ast.AST]] = [("<module>", module.tree)]
    seen: Set[int] = set()
    for node in ast.walk(module.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if id(node) not in seen:
                seen.add(id(node))
                scopes.append((node.name, node))
    for scope_name, scope_node in scopes:
        scope = _Scope(module, lock_map, scope_name, scope_node, findings)
        for child in scope_node.body:  # type: ignore[attr-defined]
            scope.visit(child)
    return findings
