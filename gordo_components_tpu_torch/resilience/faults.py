"""Fault injection at the system's seams (the port's copy of
``gordo_components_tpu/resilience/faults.py``).

Production code calls :func:`inject` / :func:`corrupt` /
:func:`damage_artifact` / :func:`tear_tail` at its boundaries; they are no-ops unless faults are
configured, by :func:`configure` or the ``GORDO_FAULTS`` environment
variable (read once, lazily). The grammar is the reference's::

    point:target:kind[:param][;point:target:kind[:param]...]

- ``point``: ``model-load``, ``engine-dispatch``, ``probe``, ``data-fetch``,
  ``store-commit``, ``spec-commit``, ``reconcile-apply``. Every one parses,
  so a reference spec is accepted whole; the port wires ``model-load``
  (the server's machine load), ``engine-dispatch`` (the engine's
  pre-dispatch seam), ``probe`` (the watchman's per-machine health check
  and the fleet control plane's per-worker probe, target the machine or
  worker name), ``data-fetch`` (the fleet build's per-machine fetch
  and the server's ``?start&end`` fetch), ``store-commit`` (the atomic
  commit), ``spec-commit`` (the fleet spec journal's append, target the
  revision number: ``error`` before it, ``torn-write`` after it) and
  ``reconcile-apply`` (between a reconciler step's WAL ``applying`` record
  and its repair, target ``<class>/<target>``);
- ``target``: a machine or endpoint name, or ``*`` for any;
- ``kind``: ``error`` (raise :class:`FaultInjected`; param = message),
  ``latency`` (sleep; param = seconds, default 0.05), ``corrupt``
  (NaN-poison the payload's first column),
  ``truncate`` / ``bitflip`` (damage a staged artifact file after its
  manifest hash was recorded; param = file name, default ``state.npz``),
  ``torn-write`` (cut a journal's final line in half).

Fired faults count into ``gordo_resilience_faults_injected_total``, and
each rule of a plan that becomes active is a control-ledger record
(``faults/inject-plan``).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, List, Optional

from ..analysis import lockcheck
from ..observability import ledger as control_ledger
from ..observability.registry import REGISTRY

logger = logging.getLogger(__name__)

ENV_VAR = "GORDO_FAULTS"

POINTS = (
    "model-load", "engine-dispatch", "probe", "data-fetch", "store-commit",
    "spec-commit", "reconcile-apply",
)
KINDS = ("error", "latency", "corrupt", "truncate", "bitflip", "torn-write")

_M_INJECTED = REGISTRY.counter(
    "gordo_resilience_faults_injected_total",
    "Faults fired by the injection harness, by boundary and kind",
    labels=("point", "kind"),
)


class FaultInjected(RuntimeError):
    """An injected ``error`` fault fired — the stand-in for a real crash."""


class _Rule:
    __slots__ = ("point", "target", "kind", "param")

    def __init__(self, point: str, target: str, kind: str, param: str):
        self.point = point
        self.target = target
        self.kind = kind
        self.param = param

    def matches(self, point: str, target: Optional[str]) -> bool:
        if self.point != point:
            return False
        return self.target == "*" or (target is not None and self.target == target)


_lock = lockcheck.named_lock("resilience.faults")
_rules: List[_Rule] = []
_configured = False  # has configure()/clear() run (beats the lazy env read)


def parse_spec(spec: str) -> List[_Rule]:
    """Parse a fault spec; raises ``ValueError`` on bad grammar, so a typo
    fails loudly instead of injecting nothing."""
    rules: List[_Rule] = []
    for chunk in spec.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        parts = chunk.split(":", 3)
        if len(parts) < 3:
            raise ValueError(f"fault rule {chunk!r} must be point:target:kind[:param]")
        point, target, kind = parts[0], parts[1], parts[2]
        param = parts[3] if len(parts) > 3 else ""
        if kind not in KINDS:
            raise ValueError(f"fault kind {kind!r} not one of {KINDS} in rule {chunk!r}")
        if kind == "latency":
            try:
                float(param or "0.05")
            except ValueError:
                raise ValueError(f"latency param must be seconds, got {param!r}") from None
        rules.append(_Rule(point, target, kind, param))
    return rules


def configure(spec: str) -> int:
    """Install a fault spec (replacing any active one); returns the rule
    count. The empty string clears."""
    global _configured
    rules = parse_spec(spec)
    with _lock:
        lockcheck.assert_guard("resilience.faults")
        _rules[:] = rules
        _configured = True
    if rules:
        logger.warning("FAULT INJECTION ACTIVE: %d rule(s) [%s]", len(rules),
                       "; ".join(f"{r.point}:{r.target}:{r.kind}" for r in rules))
    _emit_plan(rules)
    return len(rules)


def clear() -> None:
    configure("")


def _emit_plan(rules: List[_Rule]) -> None:
    """Each rule of a plan that becomes active is a control event (called
    outside the lock: the ledger fsyncs)."""
    for rule in rules:
        control_ledger.emit(
            actor="faults", action="inject-plan",
            target=f"{rule.point}:{rule.target}",
            reason=rule.kind + (f":{rule.param}" if rule.param else ""),
        )


def _active_rules() -> List[_Rule]:
    global _configured
    fresh: List[_Rule] = []
    with _lock:
        if not _configured:
            # lazy env pickup; a malformed env spec logs and injects nothing
            spec = os.environ.get(ENV_VAR, "")
            try:
                _rules[:] = parse_spec(spec) if spec else []
            except ValueError as exc:
                logger.error("Ignoring malformed %s: %s", ENV_VAR, exc)
                _rules[:] = []
            _configured = True
            if _rules:
                logger.warning("FAULT INJECTION ACTIVE from %s: %d rule(s)", ENV_VAR, len(_rules))
                fresh = list(_rules)
        rules = list(_rules)
    if fresh:
        _emit_plan(fresh)
    return rules


def active() -> bool:
    return bool(_active_rules())


def inject(point: str, target: Optional[str] = None) -> None:
    """Fire any matching ``latency``/``error`` faults at this boundary."""
    for rule in _active_rules():
        if not rule.matches(point, target):
            continue
        if rule.kind == "latency":
            _M_INJECTED.labels(point, "latency").inc()
            time.sleep(float(rule.param or "0.05"))
        elif rule.kind == "error":
            _M_INJECTED.labels(point, "error").inc()
            raise FaultInjected(rule.param or f"injected fault at {point} (target {target!r})")


def damage_artifact(point: str, target: Optional[str], directory: str) -> None:
    """Apply any matching ``truncate``/``bitflip`` fault to a staged file
    (param = file name, default ``state.npz``): truncate halves it, bitflip
    XORs its middle byte. Called after the manifest hashed the file, so the
    artifact is provably torn."""
    for rule in _active_rules():
        if rule.kind not in ("truncate", "bitflip") or not rule.matches(point, target):
            continue
        path = os.path.join(directory, rule.param or "state.npz")
        try:
            size = os.path.getsize(path)
            with open(path, "r+b") as fh:
                if rule.kind == "truncate":
                    fh.truncate(max(0, size // 2))
                else:
                    fh.seek(size // 2)
                    byte = fh.read(1) or b"\x00"
                    fh.seek(size // 2)
                    fh.write(bytes([byte[0] ^ 0xFF]))
        except OSError as exc:
            logger.warning("Fault %s:%s could not damage %s: %s", point, rule.kind, path, exc)
            continue
        _M_INJECTED.labels(point, rule.kind).inc()
        logger.warning("FAULT: %s %s at %s (target %r)", rule.kind, path, point, target)


def tear_tail(point: str, target: Optional[str], path: str) -> None:
    """Apply any matching ``torn-write`` fault to a journal file: cut its
    final line in half, the shape a crash mid-append leaves."""
    for rule in _active_rules():
        if rule.kind != "torn-write" or not rule.matches(point, target):
            continue
        try:
            with open(path, "rb") as fh:
                data = fh.read()
            stripped = data.rstrip(b"\n")
            cut = stripped.rfind(b"\n") + 1  # start of the final line
            with open(path, "r+b") as fh:
                fh.truncate(cut + max(1, (len(stripped) - cut) // 2))
        except OSError as exc:
            logger.warning("Fault %s:torn-write could not tear %s: %s", point, path, exc)
            continue
        _M_INJECTED.labels(point, "torn-write").inc()
        logger.warning("FAULT: torn-write %s at %s (target %r)", path, point, target)


def corrupt(point: str, target: Optional[str], payload: Any) -> Any:
    """Apply any matching ``corrupt`` fault: NaN-poison a float array
    payload's first column and return the copy; a payload that is no
    array passes through. ``X = faults.corrupt("engine-dispatch", name, X)``."""
    for rule in _active_rules():
        if rule.kind == "corrupt" and rule.matches(point, target):
            try:
                import numpy as np

                poisoned = np.array(payload, dtype=np.float32, copy=True)
                poisoned[..., 0] = np.nan
            except (TypeError, ValueError, IndexError):
                return payload
            _M_INJECTED.labels(point, "corrupt").inc()
            return poisoned
    return payload
