"""The versioned fleet spec: desired state as a journaled artifact (the
port's copy of ``gordo_components_tpu/fleet/spec.py``; the journal's bytes
are the reference's, so one models root holds one journal that either
package commits to and loads).

A :class:`FleetSpec` declares what the fleet SHOULD look like — per-
machine target generation and precision rung, worker floor/ceiling,
mesh shard count, canary fraction, residency cap, SLO targets, tenant
table — and parsing is LOUD: an unknown key, machine, or precision is a
:class:`SpecError` at commit time, never a silently-ignored field the
reconciler converges toward nothing.

Commits ride the store's crash-safety idioms: every revision is
one fsync'd append to ``<models_root>/.fleet/spec_journal.jsonl``, and
a ``SPEC_CURRENT`` pointer (``atomic_write_file``: sidecar + fsync +
rename) names the committed revision for cheap reads. The journal is
the truth; :meth:`SpecStore.load` fscks the pointer against it on every
read — a torn final line (crash mid-append, drilled by the
``spec-commit:…:torn-write`` fault) is dropped and the pointer repaired
backward, a pointer lost before its write is repaired forward. Rollback
never rewrites history: it appends a NEW revision whose spec is the
previous revision's spec, so the journal stays append-only and the
reconciler's idempotence keys (scoped per revision) stay valid.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .. import precision as precision_mod
from ..analysis import lockcheck
from ..observability import ledger as control_ledger
from ..observability.registry import REGISTRY
from ..resilience import faults
from ..store.atomic import atomic_write_file
from ..store.generations import GEN_PREFIX

logger = logging.getLogger(__name__)

FLEET_DIR = ".fleet"
SPEC_JOURNAL_FILE = "spec_journal.jsonl"
SPEC_CURRENT_FILE = "SPEC_CURRENT"

#: the sentinel generation pin meaning "whatever CURRENT points at" —
#: the reconciler repairs worker adoption drift but never moves the
#: pointer itself for these machines
GEN_TRACK_CURRENT = "current"

_SPEC_KEYS = frozenset(
    {
        "machines", "workers", "mesh_shards", "canary_fraction",
        "residency_cap", "slo", "tenants", "layout",
    }
)
_MACHINE_KEYS = frozenset({"generation", "precision"})
_SLO_KEYS = frozenset({"p99_ms", "availability"})

_M_COMMITS = REGISTRY.counter(
    "gordo_fleet_spec_commits_total",
    "Fleet-spec revisions committed through the journal, by kind "
    "(apply = new desired state; rollback = previous revision re-applied)",
    labels=("kind",),
)
_M_REVISION = REGISTRY.gauge(
    "gordo_fleet_spec_revision",
    "The committed fleet-spec revision this process last loaded "
    "(0 = no spec committed)",
)
_M_FSCK = REGISTRY.counter(
    "gordo_fleet_spec_fsck_total",
    "Spec-store pointer/journal repairs at load, by cause (torn_tail = "
    "pointer ahead of the last intact journal record; stale_pointer = "
    "pointer behind or missing)",
    labels=("cause",),
)


class SpecError(ValueError):
    """A fleet spec that must not be committed: unknown key/machine/
    precision, malformed bounds, or a rollback with no history."""


def _require(condition: bool, message: str) -> None:
    if not condition:
        raise SpecError(message)


@dataclass(frozen=True)
class FleetSpec:
    """The declared desired state. Immutable once parsed — revisions
    change by committing a new spec, never by mutating a loaded one."""

    machines: Dict[str, Dict[str, str]] = field(default_factory=dict)
    workers: Optional[Tuple[int, int]] = None   # (floor, ceiling)
    mesh_shards: Optional[int] = None
    canary_fraction: float = 0.25
    residency_cap: Optional[int] = None
    slo: Dict[str, float] = field(default_factory=dict)
    tenants: Optional[str] = None
    # the committed layout plan (gordo-layout-plan/v1) — validated
    # structurally at parse time; machines/workers that no longer exist
    # are an application-time degrade, never a parse error
    layout: Optional[Dict[str, Any]] = None

    @classmethod
    def parse(
        cls,
        payload: Any,
        known_machines: Optional[List[str]] = None,
    ) -> "FleetSpec":
        """Validate a JSON-shaped payload into a spec, loudly.

        ``known_machines`` (when the caller has a models root to check
        against) turns a typo'd machine name into a :class:`SpecError`
        instead of a divergence the reconciler can never repair.
        """
        _require(isinstance(payload, dict),
                 f"fleet spec must be an object, got {type(payload).__name__}")
        unknown = set(payload) - _SPEC_KEYS
        _require(not unknown,
                 f"unknown fleet-spec key(s) {sorted(unknown)} "
                 f"(allowed: {sorted(_SPEC_KEYS)})")

        machines: Dict[str, Dict[str, str]] = {}
        raw_machines = payload.get("machines") or {}
        _require(isinstance(raw_machines, dict),
                 "machines must be an object of {name: {generation, precision}}")
        for name, entry in sorted(raw_machines.items()):
            _require(isinstance(entry, dict),
                     f"machine {name!r} entry must be an object")
            bad = set(entry) - _MACHINE_KEYS
            _require(not bad,
                     f"machine {name!r} has unknown key(s) {sorted(bad)} "
                     f"(allowed: {sorted(_MACHINE_KEYS)})")
            if known_machines is not None:
                _require(name in known_machines,
                         f"unknown machine {name!r} (models root serves: "
                         f"{sorted(known_machines)})")
            pinned: Dict[str, str] = {}
            gen = entry.get("generation")
            if gen is not None:
                _require(isinstance(gen, str) and (
                    gen == GEN_TRACK_CURRENT or gen.startswith(GEN_PREFIX)
                ), f"machine {name!r}: generation must be "
                   f"{GEN_TRACK_CURRENT!r} or a gen-NNNN name, got {gen!r}")
                pinned["generation"] = gen
            rung = entry.get("precision")
            if rung is not None:
                _require(rung in precision_mod.PRECISIONS,
                         f"machine {name!r}: precision {rung!r} not on the "
                         f"ladder {precision_mod.PRECISIONS}")
                pinned["precision"] = rung
            machines[name] = pinned

        workers: Optional[Tuple[int, int]] = None
        raw_workers = payload.get("workers")
        if raw_workers is not None:
            _require(isinstance(raw_workers, dict)
                     and set(raw_workers) <= {"floor", "ceiling"},
                     "workers must be {floor, ceiling}")
            try:
                floor = int(raw_workers.get("floor", 1))
                ceiling = int(raw_workers.get("ceiling", floor))
            except (TypeError, ValueError):
                raise SpecError("workers floor/ceiling must be integers")
            _require(1 <= floor <= ceiling,
                     f"workers bounds must satisfy 1 <= floor <= ceiling, "
                     f"got floor={floor} ceiling={ceiling}")
            workers = (floor, ceiling)

        mesh_shards = payload.get("mesh_shards")
        if mesh_shards is not None:
            _require(isinstance(mesh_shards, int) and mesh_shards >= 0,
                     f"mesh_shards must be an int >= 0, got {mesh_shards!r}")

        canary_fraction = payload.get("canary_fraction", 0.25)
        _require(isinstance(canary_fraction, (int, float))
                 and 0.0 < float(canary_fraction) <= 1.0,
                 f"canary_fraction must be in (0, 1], got {canary_fraction!r}")

        residency_cap = payload.get("residency_cap")
        if residency_cap is not None:
            _require(isinstance(residency_cap, int) and residency_cap >= 1,
                     f"residency_cap must be an int >= 1, got {residency_cap!r}")

        slo: Dict[str, float] = {}
        raw_slo = payload.get("slo") or {}
        _require(isinstance(raw_slo, dict), "slo must be an object")
        bad_slo = set(raw_slo) - _SLO_KEYS
        _require(not bad_slo,
                 f"unknown slo key(s) {sorted(bad_slo)} "
                 f"(allowed: {sorted(_SLO_KEYS)})")
        for key, value in raw_slo.items():
            _require(isinstance(value, (int, float)) and value > 0,
                     f"slo {key} must be a positive number, got {value!r}")
            slo[key] = float(value)

        tenants = payload.get("tenants")
        if tenants is not None:
            _require(isinstance(tenants, str), "tenants must be a spec string")
            from ..resilience import qos

            try:
                qos.parse_tenants(tenants)
            except Exception as exc:
                raise SpecError(f"tenants spec does not parse: {exc}")

        layout = payload.get("layout")
        if layout is not None:
            # lazy import: plan.py is dependency-free, but going through
            # the layout package would pull the compiler's imports into
            # every spec parse
            from ..layout.plan import validate_layout_plan

            problems = validate_layout_plan(layout)
            _require(not problems,
                     "layout plan invalid: " + "; ".join(problems[:5]))
            # canonical deep copy: the journal must not share mutable
            # structure with whatever the caller keeps doing to payload
            layout = json.loads(json.dumps(layout, sort_keys=True))

        return cls(
            machines=machines,
            workers=workers,
            mesh_shards=mesh_shards,
            canary_fraction=float(canary_fraction),
            residency_cap=residency_cap,
            slo=slo,
            tenants=tenants,
            layout=layout,
        )

    def to_dict(self) -> Dict[str, Any]:
        payload: Dict[str, Any] = {
            "machines": {
                name: dict(entry) for name, entry in sorted(
                    self.machines.items()
                )
            },
            "canary_fraction": self.canary_fraction,
        }
        if self.workers is not None:
            payload["workers"] = {
                "floor": self.workers[0], "ceiling": self.workers[1],
            }
        if self.mesh_shards is not None:
            payload["mesh_shards"] = self.mesh_shards
        if self.residency_cap is not None:
            payload["residency_cap"] = self.residency_cap
        if self.slo:
            payload["slo"] = dict(sorted(self.slo.items()))
        if self.tenants is not None:
            payload["tenants"] = self.tenants
        if self.layout is not None:
            payload["layout"] = self.layout
        return payload


class SpecStore:
    """Journaled spec revisions under ``<models_root>/.fleet/``.

    Append-only, fsync-per-record, torn-tail tolerant — the build
    journal's WAL discipline applied to desired state. The in-memory
    record cache is guarded by one lock; every read path replays the
    journal once and fscks the pointer against it.
    """

    def __init__(self, models_root: str, clock=time.time):
        self.models_root = models_root
        self.dir = os.path.join(models_root, FLEET_DIR)
        self.journal_path = os.path.join(self.dir, SPEC_JOURNAL_FILE)
        self.pointer_path = os.path.join(self.dir, SPEC_CURRENT_FILE)
        self._clock = clock
        self._lock = lockcheck.named_lock("fleet.spec")
        self._records: List[Dict[str, Any]] = []
        self._loaded = False

    # -- journal replay / fsck ----------------------------------------------
    def _replay_locked(self) -> None:
        """(Re)load the record cache from disk: every intact journal
        line in order, a torn FINAL line dropped (the append a crash
        interrupted), then repair the pointer to the journal's truth."""
        lockcheck.assert_guard("fleet.spec")
        records: List[Dict[str, Any]] = []
        lines: List[str] = []
        if os.path.isfile(self.journal_path):
            try:
                with open(self.journal_path) as fh:
                    lines = fh.readlines()
            except OSError as exc:
                logger.warning("Spec journal unreadable: %s", exc)
        torn_bytes = 0
        for i, line in enumerate(lines):
            raw_line = line
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except ValueError:
                if i == len(lines) - 1:
                    torn_bytes = len(raw_line.encode("utf-8"))
                    logger.warning(
                        "Spec journal %s: torn final line dropped "
                        "(crash mid-append)", self.journal_path,
                    )
                else:
                    logger.warning(
                        "Spec journal %s: unparseable line %d ignored",
                        self.journal_path, i + 1,
                    )
                continue
            if isinstance(record, dict) and isinstance(
                record.get("revision"), int
            ):
                records.append(record)
        if torn_bytes:
            # fsck: chop the torn tail OFF the file, not just the
            # replay — the next append must start on a fresh line, or
            # it would concatenate onto the torn half and corrupt the
            # new record too
            try:
                size = os.path.getsize(self.journal_path)
                with open(self.journal_path, "r+b") as fh:
                    fh.truncate(max(0, size - torn_bytes))
            except OSError as exc:
                logger.warning(
                    "Spec journal %s: could not truncate torn tail: %s",
                    self.journal_path, exc,
                )
        self._records[:] = records
        self._loaded = True
        # fsck: the pointer is a cache of the journal's last revision —
        # repair it whenever the two disagree (torn tail leaves it
        # ahead; a crash between append and pointer write leaves it
        # behind or missing)
        last = records[-1]["revision"] if records else 0
        pointer: Optional[int] = None
        if os.path.isfile(self.pointer_path):
            try:
                with open(self.pointer_path) as fh:
                    pointer = int(fh.read().strip())
            except (OSError, ValueError):
                pointer = None
        if pointer != last and (records or pointer is not None):
            cause = "torn_tail" if (
                pointer is not None and pointer > last
            ) else "stale_pointer"
            _M_FSCK.labels(cause).inc()
            logger.warning(
                "Spec-store fsck: %s points at revision %s, journal says "
                "%s — repairing pointer (%s)",
                self.pointer_path, pointer, last, cause,
            )
            os.makedirs(self.dir, exist_ok=True)
            atomic_write_file(self.pointer_path, f"{last}\n")
        if torn_bytes:
            _M_REVISION.set(float(last))

    def _records_locked(self) -> List[Dict[str, Any]]:
        lockcheck.assert_guard("fleet.spec")
        if not self._loaded:
            self._replay_locked()
        return self._records

    # -- reads ---------------------------------------------------------------
    def load(self) -> Optional[Dict[str, Any]]:
        """The committed current record ``{revision, op, parent, t,
        spec}`` (journal truth, pointer fsck'd), or None before any
        commit."""
        with self._lock:
            self._replay_locked()
            record = self._records[-1] if self._records else None
        _M_REVISION.set(float(record["revision"]) if record else 0.0)
        return record

    def current_spec(self) -> Optional[Tuple[int, FleetSpec]]:
        record = self.load()
        if record is None:
            return None
        return record["revision"], FleetSpec.parse(record["spec"])

    def history(self, limit: int = 16) -> List[Dict[str, Any]]:
        with self._lock:
            records = list(self._records_locked())
        return records[-limit:]

    def record_for(self, revision: int) -> Optional[Dict[str, Any]]:
        with self._lock:
            for record in reversed(self._records_locked()):
                if record["revision"] == revision:
                    return record
        return None

    # -- commits -------------------------------------------------------------
    def _append_locked(self, record: Dict[str, Any]) -> None:
        lockcheck.assert_guard("fleet.spec")
        os.makedirs(self.dir, exist_ok=True)
        target = str(record["revision"])
        # the spec-commit fault seam: `error` models a crash BEFORE the
        # append (nothing lands), `torn-write` (below, after the append)
        # models a crash DURING it — the two halves of the store's drill
        faults.inject("spec-commit", target)
        with open(self.journal_path, "a") as fh:
            fh.write(json.dumps(record, sort_keys=True) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        faults.tear_tail("spec-commit", target, self.journal_path)
        atomic_write_file(self.pointer_path, f"{record['revision']}\n")
        self._records.append(record)

    def commit(
        self, spec: FleetSpec, op: str = "apply",
        parent: Optional[int] = None, **extra: Any,
    ) -> Dict[str, Any]:
        """Append a new revision and repoint ``SPEC_CURRENT`` at it.
        Returns the committed record."""
        with self._lock:
            records = self._records_locked()
            revision = (records[-1]["revision"] + 1) if records else 1
            if parent is None and records:
                parent = records[-1]["revision"]
            record = {
                "revision": revision,
                "op": op,
                "parent": parent,
                "t": round(float(self._clock()), 3),
                "spec": spec.to_dict(),
                **extra,
            }
            self._append_locked(record)
        _M_COMMITS.labels(op).inc()
        _M_REVISION.set(float(revision))
        logger.info(
            "Fleet spec revision %d committed (%s, parent %s)",
            revision, op, parent,
        )
        # spec revision edges are control events (emitted OUTSIDE the
        # lock — the ledger fsync must not extend the commit's critical
        # section)
        control_ledger.emit(
            actor="fleet-spec", action="commit", target=op,
            before=parent, after=revision, revision=revision,
        )
        return record

    def rollback(self, reason: str = "operator rollback") -> Dict[str, Any]:
        """Re-apply the previous revision's spec as a NEW revision —
        history is append-only, so a rollback is itself auditable (and
        itself rollback-able). Raises :class:`SpecError` with fewer than
        two revisions."""
        with self._lock:
            records = self._records_locked()
            if len(records) < 2:
                raise SpecError(
                    "nothing to roll back to: "
                    f"{len(records)} revision(s) in the journal"
                )
            current = records[-1]
            previous = records[-2]
            revision = current["revision"] + 1
            record = {
                "revision": revision,
                "op": "rollback",
                "parent": current["revision"],
                "reverted_to": previous["revision"],
                "reason": reason,
                "t": round(float(self._clock()), 3),
                "spec": previous["spec"],
            }
            self._append_locked(record)
        _M_COMMITS.labels("rollback").inc()
        _M_REVISION.set(float(record["revision"]))
        logger.warning(
            "Fleet spec rolled back: revision %d re-applies revision %d "
            "(%s)", record["revision"], record["reverted_to"], reason,
        )
        control_ledger.emit(
            actor="fleet-spec", action="rollback", target="spec",
            before=record["parent"], after=record["reverted_to"],
            reason=reason, revision=record["revision"],
        )
        return record
