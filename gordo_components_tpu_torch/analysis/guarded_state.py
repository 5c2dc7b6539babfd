"""Static guarded-state checker: declared fields only under their lock.

:data:`.locks.GUARDED_FIELDS` maps mutable attributes (and module
globals) to the one lock that owns them. This checker flags any read or
write of a declared field outside a lexical ``with <its lock>:`` scope.
The lock-ordering checker (:mod:`.lock_discipline`) proves acquisitions
nest legally; THIS one proves the state those locks exist for is never
touched without them — the invariant a multi-host refactor must keep
while it moves state across processes.

Resolution mirrors :mod:`.lock_discipline`'s self/bare-callee rule,
made transitive by a fixpoint: a helper whose every same-module call
site (bare name or ``self.method``) sits inside ``with <lock>:`` — or
inside a function itself always called under it — is BLESSED for that
lock, because the caller's critical section extends into it (the
``_evaluate_locked`` → ``_journal_locked`` chains). A helper with any
unguarded call site (or none the checker can see — cross-object calls
like ``bucket._promote()`` are deliberately not resolved) gets no
blessing: annotate the access with
``# lint: allow-unguarded(<reason>)`` if the contract really holds.
``__init__``/``__new__`` are exempt — construction happens-before
publication.

The runtime twin is :func:`.lockcheck.assert_guard`: mutation sites
assert the guard is actually HELD under ``GORDO_LOCKCHECK=1``, so the
blessing above (and every escape hatch) is witnessed by real
executions, not just believed.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .astscan import Module, attr_chain_names, dotted
from .findings import Finding
from .locks import GUARDED_FIELDS, LOCK_ATTRS

CHECKER = "guarded-state"

_EXEMPT_SCOPES = frozenset({"__init__", "__new__"})


def _field_map_for(relpath: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for (suffix, attr), lock in GUARDED_FIELDS.items():
        if relpath.endswith(suffix):
            out[attr] = lock
    return out


def _lock_map_for(relpath: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for (suffix, attr), name in LOCK_ATTRS.items():
        if relpath.endswith(suffix):
            out[attr] = name
    return out


def _is_function(node: ast.AST) -> bool:
    return isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))


class _Access:
    __slots__ = ("field", "lock", "line", "scope", "write")

    def __init__(self, field: str, lock: str, line: int, scope: str,
                 write: bool):
        self.field = field
        self.lock = lock
        self.line = line
        self.scope = scope
        self.write = write


class _ScopeWalk:
    """One function (or module) body: collect guarded-field accesses not
    lexically under their lock, plus every same-module call site with
    the lock set held at that site (for the blessing pass). Scope names
    are class-qualified (``Bucket._promote``) so that same-named
    methods of DIFFERENT classes never share blessing: ``self.method``
    resolves inside the walker's own class, bare names to module-level
    functions."""

    def __init__(self, module: Module, field_map: Dict[str, str],
                 lock_map: Dict[str, str], scope_name: str,
                 class_name: Optional[str] = None):
        self.module = module
        self.field_map = field_map
        self.lock_map = lock_map
        self.scope_name = scope_name
        self.class_name = class_name
        self.held: List[str] = []
        self.unguarded: List[_Access] = []
        # callee short name -> held-lock sets at its call sites here
        self.call_sites: Dict[str, List[Set[str]]] = {}

    def visit(self, node: ast.AST) -> None:
        if _is_function(node):
            return  # separate scope: walked on its own with no locks held
        # Lambdas are NOT skipped: their bodies are checked with the
        # locks lexically held at the definition site. The dominant
        # pattern is immediate invocation (a sort/max key under the
        # lock); a deferred lambda that escapes its critical section is
        # the same one-sided faith every lexical check here takes.
        if isinstance(node, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in node.items:
                for sub in ast.walk(item.context_expr):
                    self._check_leaf(sub)
                lock = self._resolve_lock(item.context_expr)
                if lock is not None:
                    self.held.append(lock)
                    pushed += 1
            try:
                for child in node.body:
                    self.visit(child)
            finally:
                if pushed:
                    del self.held[-pushed:]
            return
        self._check_leaf(node)
        for child in ast.iter_child_nodes(node):
            self.visit(child)

    def _check_leaf(self, node: ast.AST) -> None:
        if isinstance(node, ast.Call):
            name = dotted(node.func)
            if name:
                parts = name.split(".")
                callee: Optional[str] = None
                if len(parts) == 1:
                    callee = parts[0]  # module-level function
                elif len(parts) == 2 and parts[0] == "self" and (
                    self.class_name is not None
                ):
                    callee = f"{self.class_name}.{parts[1]}"
                if callee is not None:
                    self.call_sites.setdefault(callee, []).append(
                        set(self.held)
                    )
        field: Optional[str] = None
        write = False
        if isinstance(node, ast.Attribute) and node.attr in self.field_map:
            field = node.attr
            write = isinstance(node.ctx, (ast.Store, ast.Del))
        elif isinstance(node, ast.Name) and node.id in self.field_map:
            # module-global guarded state (faults._rules); skip the
            # declaration site itself (module scope Store at import)
            if self.scope_name == "<module>" and isinstance(
                node.ctx, ast.Store
            ):
                return
            field = node.id
            write = isinstance(node.ctx, (ast.Store, ast.Del))
        if field is None:
            return
        lock = self.field_map[field]
        if lock in self.held:
            return
        self.unguarded.append(
            _Access(field, lock, node.lineno, self.scope_name, write)
        )

    def _resolve_lock(self, expr: ast.AST) -> Optional[str]:
        for name in attr_chain_names(expr):
            lock = self.lock_map.get(name)
            if lock is not None:
                return lock
        return None


def _blessed_guards(
    scope_names: Set[str],
    called_under: Dict[str, List[Tuple[str, Set[str]]]],
    relevant: Set[str],
) -> Dict[str, Set[str]]:
    """Least fixpoint: the set of guard locks PROVABLY held whenever
    each function runs. A function with no visible call site (an entry
    point, or one only reached through unresolvable receivers) holds
    nothing; otherwise it holds the intersection over call sites of
    (lexical locks at the site ∪ what the calling scope itself provably
    holds). Starting EMPTY and iterating upward matters: blessing must
    be earned from a real guarded entry point, never self-supported —
    an optimistic start would let a recursive function (or a mutual
    cycle) whose only visible call sites are its own bless itself for
    every lock. The transfer is monotone on the ⊆-lattice, so upward
    iteration terminates."""
    guards: Dict[str, Set[str]] = {name: set() for name in scope_names}
    guards["<module>"] = set()
    changed = True
    while changed:
        changed = False
        for name in scope_names:
            sites = called_under.get(name)
            if not sites:
                continue
            new: Optional[Set[str]] = None
            for caller, held in sites:
                effective = held | guards.get(caller, set())
                new = effective if new is None else (new & effective)
            new = (new or set()) & relevant
            if new != guards[name]:
                guards[name] = new
                changed = True
    return guards


def check(module: Module) -> List[Finding]:
    field_map = _field_map_for(module.relpath)
    if not field_map:
        return []
    lock_map = _lock_map_for(module.relpath)

    # function -> enclosing class (innermost), so scope names qualify
    enclosing_class: Dict[int, str] = {}
    for node in ast.walk(module.tree):
        if isinstance(node, ast.ClassDef):
            for child in ast.walk(node):
                if _is_function(child):
                    enclosing_class.setdefault(id(child), node.name)

    scopes: List[Tuple[str, Optional[str], ast.AST]] = [
        ("<module>", None, module.tree)
    ]
    for node in ast.walk(module.tree):
        if _is_function(node):
            cls = enclosing_class.get(id(node))
            name = f"{cls}.{node.name}" if cls else node.name
            scopes.append((name, cls, node))

    walks: List[_ScopeWalk] = []
    # qualified callee name -> (caller scope name, held-lock set) per site
    called_under: Dict[str, List[Tuple[str, Set[str]]]] = {}
    for scope_name, cls, scope_node in scopes:
        walk = _ScopeWalk(module, field_map, lock_map, scope_name, cls)
        for child in scope_node.body:  # type: ignore[attr-defined]
            walk.visit(child)
        walks.append(walk)
        for callee, held_sets in walk.call_sites.items():
            called_under.setdefault(callee, []).extend(
                (scope_name, held) for held in held_sets
            )

    guards = _blessed_guards(
        {walk.scope_name for walk in walks}, called_under,
        set(field_map.values()),
    )

    findings: List[Finding] = []
    flagged: Set[Tuple[str, str, str]] = set()
    for walk in walks:
        if walk.scope_name.rsplit(".", 1)[-1] in _EXEMPT_SCOPES:
            continue
        for access in walk.unguarded:
            # transitive blessing: every visible call-site chain of this
            # scope holds the guard -> the callers' critical sections
            # cover us
            if access.lock in guards.get(walk.scope_name, frozenset()):
                continue
            suppression = module.allows("unguarded", access.line)
            if suppression is not None:
                if not suppression.reason:
                    findings.append(
                        Finding(
                            checker=CHECKER, code="empty-escape-reason",
                            file=module.relpath, line=access.line,
                            key=f"{access.scope}:{access.field}",
                            message=(
                                "allow-unguarded escape hatch carries no "
                                "reason — the reason is the contract"
                            ),
                            hint=(
                                "write # lint: allow-unguarded(<why the "
                                "lock-free access is safe>)"
                            ),
                        )
                    )
                continue
            dedupe = (access.scope, access.field, access.lock)
            if dedupe in flagged:
                continue
            flagged.add(dedupe)
            verb = "mutates" if access.write else "reads"
            findings.append(
                Finding(
                    checker=CHECKER, code="unguarded-access",
                    file=module.relpath, line=access.line,
                    key=f"{access.field}:{access.scope}",
                    message=(
                        f"{access.scope} {verb} {access.field!r} outside "
                        f"'with <{access.lock}>:' — the field is declared "
                        f"guarded by {access.lock!r} (analysis/locks.py "
                        "GUARDED_FIELDS)"
                    ),
                    hint=(
                        "take the guarding lock, call this only from "
                        "under it, or annotate the line with "
                        "# lint: allow-unguarded(<reason>)"
                    ),
                )
            )
    return findings
