"""Runtime lock-order validator: the witness half of lock discipline.

Static analysis (:mod:`.lock_discipline`) proposes an order from the
source; this module CONFIRMS it at runtime. With ``GORDO_LOCKCHECK=1``
in the environment before the port is imported, every architectural
lock of the port is created through :func:`named_lock` /
:func:`named_condition` as a thin tracked wrapper: each acquisition
records (held-locks -> new-lock) edges per thread and immediately
checks them against the declared hierarchy in :mod:`.locks`. A run of
the port's tests (or ``chip_smoke.py``'s witness phase) with the knob
set reads :func:`violations` / :func:`report` at its end;
:func:`report` also re-checks the accumulated edge set for cycles —
redundant under a rank order, kept as a belt-and-braces check.

With the knob off (the default), the factories return plain
``threading.Lock`` / ``threading.Condition`` objects — zero wrappers,
zero overhead, bit-identical behavior. Never enable in production
serving: every acquisition pays a thread-local list walk.

Same-NAME nesting across different instances (two buckets' hot locks)
would be reported as an inversion; no code path does that today, and
any future one should justify itself by renaming the second lock into
its own rank slot.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set, Tuple

from .locks import LOCK_RANKS


def _enabled() -> bool:
    return os.environ.get("GORDO_LOCKCHECK", "0").strip().lower() not in (
        "", "0", "false", "off", "no",
    )


enabled = _enabled()

_held = threading.local()          # per-thread stack of lock names
_state_lock = threading.Lock()     # guards the two tables below
_edges: Dict[Tuple[str, str], int] = {}   # (outer, inner) -> times seen
_violations: List[str] = []


def _stack() -> List[str]:
    stack = getattr(_held, "stack", None)
    if stack is None:
        stack = _held.stack = []
    return stack


def _note_acquired(name: str) -> None:
    stack = _stack()
    for outer in stack:
        edge = (outer, name)
        with _state_lock:
            _edges[edge] = _edges.get(edge, 0) + 1
        if LOCK_RANKS[name] <= LOCK_RANKS[outer]:
            message = (
                f"lock-order violation on thread "
                f"{threading.current_thread().name!r}: acquired "
                f"{name!r} (rank {LOCK_RANKS[name]}) while holding "
                f"{outer!r} (rank {LOCK_RANKS[outer]}); declared order "
                "is strictly rank-increasing (analysis/locks.py)"
            )
            with _state_lock:
                _violations.append(message)
    stack.append(name)


def _note_released(name: str) -> None:
    stack = _stack()
    # release order may differ from acquisition order (with-blocks can
    # interleave with explicit acquire/release); remove the most recent
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] == name:
            del stack[i]
            return


class TrackedLock:
    """A named ``threading.Lock`` recording acquisition order. Exposes
    the protocol ``threading.Condition`` needs (``_is_owned`` via owner
    tracking) so it can back a condition too."""

    def __init__(self, name: str):
        if name not in LOCK_RANKS:
            raise ValueError(
                f"lock {name!r} is not declared in analysis/locks.py — "
                "add it to LOCK_RANKS"
            )
        self._name = name
        self._lock = threading.Lock()
        self._owner: Optional[int] = None

    # -- lock protocol -------------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        acquired = self._lock.acquire(blocking, timeout)
        if acquired:
            self._owner = threading.get_ident()
            _note_acquired(self._name)
        return acquired

    def release(self) -> None:
        _note_released(self._name)
        self._owner = None
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc_info) -> None:
        self.release()

    # -- Condition support ---------------------------------------------------
    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def _release_save(self):
        # Condition.wait: the lock is dropped while waiting, so the
        # held-stack entry must go too (a notify-side acquisition during
        # our wait is NOT nested under us)
        _note_released(self._name)
        self._owner = None
        self._lock.release()

    def _acquire_restore(self, saved) -> None:
        self._lock.acquire()
        self._owner = threading.get_ident()
        _note_acquired(self._name)

    def __repr__(self) -> str:
        return f"<TrackedLock {self._name} {self._lock!r}>"


def named_lock(name: str):
    """A lock participating in the declared hierarchy: tracked under
    ``GORDO_LOCKCHECK=1``, a plain ``threading.Lock`` otherwise."""
    if not enabled:
        return threading.Lock()
    return TrackedLock(name)


def named_condition(name: str):
    """A condition whose underlying latch participates in the declared
    hierarchy (the wait/notify handoff is order-transparent: waiting
    releases the lock and re-entering records a fresh acquisition)."""
    if not enabled:
        return threading.Condition()
    return threading.Condition(TrackedLock(name))


# -- guarded-state runtime twin ----------------------------------------------


def assert_guard(name: str) -> None:
    """Runtime half of the guarded-state contract (GUARDED_FIELDS in
    :mod:`.locks`): mutation sites call this with the OWNING lock's name
    and, under ``GORDO_LOCKCHECK=1``, a violation is recorded when the
    calling thread does not hold it. The static checker
    (:mod:`.guarded_state`) proves the lexical shape; this witnesses
    the dynamic one — including every ``allow-unguarded`` escape and
    one-level blessing the static pass took on faith. With the knob off
    it is a single early return, cheap enough for dispatch-path
    mutation sites."""
    if not enabled:
        return
    if name not in LOCK_RANKS:
        raise ValueError(
            f"guard {name!r} is not declared in analysis/locks.py — "
            "add it to LOCK_RANKS"
        )
    if name not in _stack():
        import traceback

        # extract_stack(limit=2) keeps the two INNERMOST frames,
        # oldest-first: [0] is the mutation site that called
        # assert_guard, [1] is this frame
        site = traceback.extract_stack(limit=2)[0]
        message = (
            f"guarded-state violation on thread "
            f"{threading.current_thread().name!r}: mutation at "
            f"{site.filename}:{site.lineno} ({site.name}) without "
            f"holding its declared guard {name!r} "
            f"(held: {_stack() or 'nothing'})"
        )
        with _state_lock:
            _violations.append(message)


# -- reporting ---------------------------------------------------------------


def violations() -> List[str]:
    with _state_lock:
        return list(_violations)


def observed_edges() -> Dict[Tuple[str, str], int]:
    with _state_lock:
        return dict(_edges)


def reset() -> None:
    with _state_lock:
        _edges.clear()
        _violations.clear()


def _find_cycle(edges: Set[Tuple[str, str]]) -> Optional[List[str]]:
    graph: Dict[str, List[str]] = {}
    for outer, inner in edges:
        graph.setdefault(outer, []).append(inner)
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    path: List[str] = []

    def visit(node: str) -> Optional[List[str]]:
        color[node] = GRAY
        path.append(node)
        for nxt in graph.get(node, ()):
            state = color.get(nxt, WHITE)
            if state == GRAY:
                return path[path.index(nxt):] + [nxt]
            if state == WHITE:
                cycle = visit(nxt)
                if cycle is not None:
                    return cycle
        path.pop()
        color[node] = BLACK
        return None

    for node in list(graph):
        if color.get(node, WHITE) == WHITE:
            cycle = visit(node)
            if cycle is not None:
                return cycle
    return None


def report() -> List[str]:
    """All problems the run witnessed: per-acquisition rank violations
    plus a whole-graph cycle check over the observed edge set."""
    problems = violations()
    cycle = _find_cycle(set(observed_edges()))
    if cycle is not None:
        problems.append(
            "cycle in observed lock-acquisition graph: "
            + " -> ".join(cycle)
        )
    return problems
