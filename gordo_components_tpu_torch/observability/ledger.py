"""The control ledger: one durable, causally ordered journal of every
control-plane decision (the port's copy of
``gordo_components_tpu/observability/ledger.py``).

Every control-plane writer (quarantine and recovery, QoS shed-level moves,
fault plans becoming active, the breaker, SLO breach edges and the
autopilot's decisions) emits one ``gordo-control-event/v1`` record here:
fsync'd JSONL segments, whole-segment deletion under a byte budget, a torn
final line tolerated on reload.

- **Emit never raises and never blocks the data plane.** A failure counts
  a drop and returns ``None``. Writers holding a hot lock (the admission
  gate) stash the transition and emit after releasing it.
- **The ledger lock is a leaf**: ``emit`` takes nothing else inside it.
- **Bounded** by ``GORDO_LEDGER_MB`` / ``GORDO_LEDGER_SEGMENT_KB``;
  ``directory=None`` runs memory-only with the same accounting;
  ``GORDO_LEDGER=0`` counts every emit as a drop.

``seq`` is a per-process monotonic sequence number restored across
restarts from the reloaded tail, so a reader can detect a gap and order
events when wall clocks step.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..analysis import lockcheck
from .registry import REGISTRY

logger = logging.getLogger(__name__)

SCHEMA = "gordo-control-event/v1"

# the closed actor vocabulary (also the metric label domain — bounded
# by construction). Every control-plane writer appears exactly once.
ACTORS = (
    "autopilot",    # decision journal (scale up/down/hold, enable/disable)
    "reconciler",   # repair attempts (respawn, pin, rebuild, adopt)
    "fleet-spec",   # spec commits + rollbacks (revision edges)
    "rollout",      # canary / sweep / rollback steps
    "layout",       # plan applies / reverts on a worker
    "qos",          # shed-level movements
    "quarantine",   # machine quarantine / recovery
    "breaker",      # circuit state transitions
    "slo",          # burn-rate breach edges
    "faults",       # GORDO_FAULTS plans becoming active
    "operator",     # direct CLI / curl actions that bypass a loop
)

# every event carries exactly these keys (validate_event enforces it)
_REQUIRED = ("schema", "seq", "ts", "actor", "action", "target")
_OPTIONAL = ("before", "after", "reason", "trace_id", "revision")

_M_EVENTS = REGISTRY.counter(
    "gordo_incident_ledger_events_total",
    "Control-ledger events appended, by emitting control-plane actor",
    labels=("actor",),
)
_M_DROPS = REGISTRY.counter(
    "gordo_incident_ledger_drops_total",
    "Control-ledger events dropped (emit failed; the ledger never "
    "raises into a control loop)",
)
_M_BYTES = REGISTRY.gauge(
    "gordo_incident_ledger_bytes",
    "Bytes currently held by the control ledger across all segments "
    "(bounded by GORDO_LEDGER_MB)",
)


def enabled() -> bool:
    """``GORDO_LEDGER``: set to ``0`` to disable all ledger writes
    (events are counted as drops so the silence is visible)."""
    return os.environ.get("GORDO_LEDGER", "1") not in ("0", "false", "no")


def byte_budget() -> int:
    """``GORDO_LEDGER_MB``: hard byte budget across all ledger
    segments; the oldest segments are deleted to stay under it."""
    try:
        mb = float(os.environ.get("GORDO_LEDGER_MB", "16"))
    except ValueError:
        mb = 16.0
    return max(1 << 16, int(mb * (1 << 20)))


def segment_bytes() -> int:
    """``GORDO_LEDGER_SEGMENT_KB``: rotate the active ledger segment
    once it crosses this many KiB (retention granularity: the budget
    deletes whole segments)."""
    try:
        kb = float(os.environ.get("GORDO_LEDGER_SEGMENT_KB", "128"))
    except ValueError:
        kb = 128.0
    return max(1 << 12, int(kb * 1024))


def validate_event(event: Any) -> List[str]:
    """Schema check for one ``gordo-control-event/v1`` document.
    Returns a list of human-readable problems (empty = valid)."""
    problems: List[str] = []
    if not isinstance(event, dict):
        return [f"event is {type(event).__name__}, not an object"]
    if event.get("schema") != SCHEMA:
        problems.append(f"schema is {event.get('schema')!r}, want {SCHEMA!r}")
    for key in _REQUIRED:
        if key not in event:
            problems.append(f"missing required key {key!r}")
    if not isinstance(event.get("seq"), int):
        problems.append("seq must be an integer")
    if not isinstance(event.get("ts"), (int, float)):
        problems.append("ts must be a number (unix seconds)")
    actor = event.get("actor")
    if actor not in ACTORS:
        problems.append(f"actor {actor!r} not in the declared vocabulary")
    if not isinstance(event.get("action"), str) or not event.get("action"):
        problems.append("action must be a non-empty string")
    if not isinstance(event.get("target"), str):
        problems.append("target must be a string (may be empty)")
    for key in set(event) - set(_REQUIRED) - set(_OPTIONAL):
        problems.append(f"unknown key {key!r}")
    return problems


class ControlLedger:
    """Append-only JSONL event journal for one process.

    ``directory=None`` runs memory-only; otherwise every event is
    flushed + fsync'd before ``emit`` returns, segments rotate at
    ``segment_limit`` and whole oldest segments are deleted past
    ``budget`` (never the active one).
    """

    def __init__(
        self,
        directory: Optional[str] = None,
        wall: Callable[[], float] = time.time,
        budget: Optional[int] = None,
        segment_limit: Optional[int] = None,
    ):
        self.directory = directory
        self._wall = wall
        self.budget = budget if budget is not None else byte_budget()
        self.segment_limit = (
            segment_limit if segment_limit is not None else segment_bytes()
        )
        self._lock = lockcheck.named_lock("observability.ledger")
        # (segment_seq, record_bytes, event) oldest-first — query index
        # and byte ledger share one list so budget trims are exact
        self._index: List[Tuple[int, int, Dict[str, Any]]] = []
        self._seg_bytes: Dict[int, int] = {}
        self._seg_seq = 0
        self._active_fh = None
        self._active_bytes = 0
        self._seq = 0  # next event sequence number (monotonic, durable)
        self.events = 0
        self.drops = 0
        self.rotations = 0
        if directory is not None:
            os.makedirs(directory, exist_ok=True)
            with self._lock:
                self._reload()

    # -- durable segments -----------------------------------------------------
    def _seg_path(self, seq: int) -> str:
        assert self.directory is not None
        return os.path.join(self.directory, f"seg-{seq:08d}.jsonl")

    def _reload(self) -> None:
        """Rebuild the in-memory index from on-disk segments, WAL-style:
        a torn FINAL line (crash mid-append) resumes silently one event
        short; corrupt mid-file lines are skipped loudly. ``_seq``
        resumes past the highest durable sequence number."""
        assert self.directory is not None
        names = sorted(
            n for n in os.listdir(self.directory)
            if n.startswith("seg-") and n.endswith(".jsonl")
        )
        for name in names:
            path = os.path.join(self.directory, name)
            try:
                seq = int(name[len("seg-"):-len(".jsonl")])
            except ValueError:
                logger.warning("ledger: ignoring alien file %s", path)
                continue
            self._seg_seq = max(self._seg_seq, seq + 1)
            try:
                with open(path, "r") as fh:
                    lines = fh.readlines()
            except OSError as exc:
                logger.warning("ledger: unreadable segment %s: %s",
                               path, exc)
                continue
            kept = 0
            for i, line in enumerate(lines):
                if not line.strip():
                    continue
                try:
                    event = json.loads(line)
                except ValueError:
                    final = (name == names[-1] and i == len(lines) - 1)
                    if final:
                        logger.info(
                            "ledger: ignoring torn final line in %s "
                            "(crash mid-append)", path,
                        )
                    else:
                        logger.warning(
                            "ledger: skipping corrupt line %d in %s",
                            i + 1, path,
                        )
                    continue
                nbytes = len(line.encode("utf-8"))
                self._index.append((seq, nbytes, event))
                if isinstance(event.get("seq"), int):
                    self._seq = max(self._seq, event["seq"] + 1)
                kept += 1
            self._seg_bytes[seq] = os.path.getsize(path)
            logger.info("ledger: reloaded %d event(s) from %s", kept, path)
        self._trim_locked()

    def _append_locked(self, event: Dict[str, Any]) -> None:
        line = json.dumps(event, separators=(",", ":")) + "\n"
        nbytes = len(line.encode("utf-8"))
        if self.directory is not None:
            if self._active_fh is None:
                seq = self._seg_seq
                self._seg_seq += 1
                self._active_fh = open(self._seg_path(seq), "a")
                self._active_seq = seq
                self._active_bytes = 0
                self._seg_bytes[seq] = 0
            self._active_fh.write(line)
            self._active_fh.flush()
            os.fsync(self._active_fh.fileno())
            self._active_bytes += nbytes
            self._seg_bytes[self._active_seq] += nbytes
            self._index.append((self._active_seq, nbytes, event))
            if self._active_bytes >= self.segment_limit:
                self._active_fh.close()
                self._active_fh = None
                self.rotations += 1
        else:
            # memory-only: same ledger, records ARE the segments
            seq = self._seg_seq
            self._index.append((seq, nbytes, event))
            self._seg_bytes[seq] = self._seg_bytes.get(seq, 0) + nbytes
            if self._seg_bytes[seq] >= self.segment_limit:
                self._seg_seq += 1
        self._trim_locked()
        _M_BYTES.set(float(self.total_bytes()))

    def _trim_locked(self) -> None:
        """Enforce the byte budget by deleting whole oldest segments
        (never the active one)."""
        while len(self._seg_bytes) > 1 and self.total_bytes() > self.budget:
            oldest = min(self._seg_bytes)
            active = getattr(self, "_active_seq", None)
            if self._active_fh is not None and oldest == active:
                break
            del self._seg_bytes[oldest]
            self._index = [
                entry for entry in self._index if entry[0] != oldest
            ]
            if self.directory is not None:
                try:
                    os.unlink(self._seg_path(oldest))
                except OSError as exc:
                    logger.warning(
                        "ledger: could not delete segment %d: %s",
                        oldest, exc,
                    )

    def total_bytes(self) -> int:
        return sum(self._seg_bytes.values())

    # -- the one write path ---------------------------------------------------
    def emit(
        self,
        actor: str,
        action: str,
        target: str = "",
        before: Any = None,
        after: Any = None,
        reason: str = "",
        trace_id: str = "",
        revision: Any = None,
    ) -> Optional[Dict[str, Any]]:
        """Append one control event. NEVER raises — a failed append is
        counted as a drop and returns ``None`` (journaling must never
        break actuation)."""
        if not enabled():
            self.drops += 1
            _M_DROPS.inc()
            return None
        try:
            with self._lock:
                lockcheck.assert_guard("observability.ledger")
                event: Dict[str, Any] = {
                    "schema": SCHEMA,
                    "seq": self._seq,
                    "ts": round(self._wall(), 3),
                    "actor": actor,
                    "action": action,
                    "target": str(target),
                }
                if before is not None:
                    event["before"] = before
                if after is not None:
                    event["after"] = after
                if reason:
                    event["reason"] = str(reason)
                if trace_id:
                    event["trace_id"] = str(trace_id)
                if revision is not None:
                    event["revision"] = revision
                self._seq += 1
                self._append_locked(event)
                self.events += 1
            _M_EVENTS.labels(actor if actor in ACTORS else "operator").inc()
            return event
        except Exception:
            self.drops += 1
            _M_DROPS.inc()
            logger.exception("ledger: dropped %s/%s event", actor, action)
            return None

    def _adopt(self, event: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Carry one pre-configure event into this ledger's sequence
        space (boot-buffer replay): payload and original ``ts`` kept,
        ``seq`` re-stamped past any durable history. Metric-silent —
        the event was already counted when first emitted."""
        try:
            with self._lock:
                lockcheck.assert_guard("observability.ledger")
                carried = dict(event)
                carried["seq"] = self._seq
                self._seq += 1
                self._append_locked(carried)
                self.events += 1
            return carried
        except Exception:
            self.drops += 1
            _M_DROPS.inc()
            return None

    # -- queries --------------------------------------------------------------
    def recent(
        self,
        window: Optional[float] = None,
        limit: Optional[int] = None,
        now: Optional[float] = None,
    ) -> List[Dict[str, Any]]:
        """Events inside the trailing ``window`` seconds (all retained
        history when ``None``), oldest-first, newest ``limit`` kept."""
        now = self._wall() if now is None else now
        with self._lock:
            events = [entry[2] for entry in self._index]
        if window is not None:
            horizon = now - window
            events = [
                e for e in events
                if isinstance(e.get("ts"), (int, float)) and e["ts"] >= horizon
            ]
        if limit is not None and limit >= 0:
            events = events[-limit:]
        return events

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": enabled(),
                "durable": self.directory is not None,
                "events": self.events,
                "drops": self.drops,
                "rotations": self.rotations,
                "segments": len(self._seg_bytes),
                "bytes": self.total_bytes(),
                "next_seq": self._seq,
                "retained": len(self._index),
            }

    def close(self) -> None:
        with self._lock:
            if self._active_fh is not None:
                self._active_fh.close()
                self._active_fh = None


# process-global ledger: memory-only until a serving role calls
# configure() with its durable directory. Writers go through emit()
# below so reconfiguration swaps the sink under everyone at once.
LEDGER = ControlLedger()
_configure_lock = threading.Lock()


def configure(
    directory: Optional[str],
    wall: Callable[[], float] = time.time,
    budget: Optional[int] = None,
    segment_limit: Optional[int] = None,
) -> ControlLedger:
    """Point the process-global ledger at a durable directory (server /
    router boot). Idempotent for the same directory."""
    global LEDGER
    with _configure_lock:
        if LEDGER.directory == directory and directory is not None:
            return LEDGER
        old = LEDGER
        fresh = ControlLedger(
            directory=directory, wall=wall,
            budget=budget, segment_limit=segment_limit,
        )
        if old.directory is None:
            # events emitted before the serving role attached its durable
            # directory (e.g. a --faults plan activated at CLI-parse time)
            # must not vanish — the chaos drill that burns the SLO is the
            # correlator's strongest candidate. Durable→durable switches
            # do NOT replay: that history already lives in the old dir.
            for event in old.recent():
                fresh._adopt(event)
        LEDGER = fresh
        old.close()
        return LEDGER


def emit(
    actor: str,
    action: str,
    target: str = "",
    before: Any = None,
    after: Any = None,
    reason: str = "",
    trace_id: str = "",
    revision: Any = None,
) -> Optional[Dict[str, Any]]:
    """Module-level emit: every control-plane writer calls this; it
    forwards to whatever ledger configure() last installed."""
    return LEDGER.emit(
        actor, action, target=target, before=before, after=after,
        reason=reason, trace_id=trace_id, revision=revision,
    )
