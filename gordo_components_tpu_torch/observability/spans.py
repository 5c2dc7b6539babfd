"""Per-request span timelines: stage-level latency attribution (the port's
copy of ``gordo_components_tpu/observability/spans.py``).

Serving runs in overlapping stages (admission gate, bucket queue, leader
dispatch, device execution, collector fetch, wire encode) on three
threads, so a histogram can say that a request was slow but not where. A
:class:`Timeline` is the per-request answer: named stage spans with start
and duration, point events (deadline expiry, a shed, a quota refusal), and
a Chrome trace-event export that loads in Perfetto.

Context: the handler thread binds its timeline to a context variable
(:func:`begin`), so code on that thread records with :func:`stage`. The
engine's leader and collector threads do not inherit it: work that crosses
to them carries an explicit :class:`SpanContext` (:func:`capture` at
submit, :func:`bind` / :func:`record_into` on the far side), which also
restores the trace id for log records emitted there.

Cost: a stage is one ``perf_counter`` pair, one histogram observe
(``gordo_stage_seconds{stage}``) and, when a timeline is bound, one
lock-guarded list append. Nothing here touches the device.
"""

from __future__ import annotations

import contextlib
import threading
import time
from contextvars import ContextVar
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

from ..analysis import lockcheck
from . import tracing
from .registry import REGISTRY

# the canonical stage names; stage() accepts
# any name — this tuple is the shared vocabulary, not an enum
STAGES = (
    "route",           # router: placement decision + worker forward
                       # (re-route walks included)
    "admission",       # admission-gate wait (server)
    "queue_wait",      # bucket pending queue until a leader dispatches it
    "megabatch",       # leader's bounded fill window collecting concurrent
                       # submits across machines into one fused dispatch
    "dispatch",        # pre-dispatch seams + async enqueue (leader thread)
    "device_execute",  # enqueue -> fetch-begin (device compute overlap)
    "fetch",           # the wait on the dispatch's event + host views
    "score",           # whole engine/host scoring call (parent span)
    "encode",          # response wire encoding (npz / fast JSON)
    "chunk_fetch",     # client: one chunk's HTTP round-trip
    "decode",          # client: response body -> arrays
)

_M_STAGE_SECONDS = REGISTRY.histogram(
    "gordo_stage_seconds",
    "Duration of named request stages (the aggregate twin of the "
    "per-request timelines in /debug/requests)",
    labels=("stage",),
)
# bound-series cache: stage() / record_into() run several times per
# request, and labels() re-validates + re-tuples per call otherwise
_BOUND_STAGE: Dict[str, Any] = {}


def _stage_series(name: str):
    bound = _BOUND_STAGE.get(name)
    if bound is None:
        bound = _BOUND_STAGE[name] = _M_STAGE_SECONDS.labels(name)
    return bound

_timeline: ContextVar[Optional["Timeline"]] = ContextVar(
    "gordo_timeline", default=None
)


class Span:
    __slots__ = ("name", "start", "duration", "thread", "process", "attrs")

    def __init__(self, name: str, start: float, duration: float,
                 thread: str, attrs: Dict[str, Any], process: str = ""):
        self.name = name
        self.start = start  # seconds since timeline start
        self.duration = duration
        self.thread = thread
        # "" = this process; anything else is a STITCHED lane — a remote
        # process's span merged in by the router (observability.stitch)
        self.process = process
        self.attrs = attrs


class Timeline:
    """One request's stage spans + point events.

    Thread-safe appends: the handler thread, the bucket leader (which may
    be ANOTHER request's handler draining the queue), and the collector
    thread all record into one request's timeline concurrently.
    """

    __slots__ = ("trace_id", "meta", "started_wall", "started", "finished",
                 "status", "error", "spans", "events", "_lock")

    def __init__(self, trace_id: str, **meta: Any):
        self.trace_id = trace_id
        self.meta = {k: v for k, v in meta.items() if v is not None}
        self.started_wall = time.time()
        self.started = time.perf_counter()
        self.finished: Optional[float] = None  # perf_counter at finish
        self.status = ""   # e.g. HTTP status, "ok", "error"
        self.error = ""
        self.spans: List[Span] = []
        self.events: List[Dict[str, Any]] = []
        self._lock = lockcheck.named_lock("observability.spans")

    # -- recording (any thread) ----------------------------------------------
    def add_span(self, name: str, started: float, duration: float,
                 **attrs: Any) -> None:
        """``started`` is an absolute ``time.perf_counter()`` reading (the
        recorder converts to timeline-relative) so cross-thread recorders
        never need the timeline's epoch."""
        if attrs:
            attrs = {k: v for k, v in attrs.items() if v not in (None, "")}
        span = Span(
            name,
            max(0.0, started - self.started),
            max(0.0, duration),
            threading.current_thread().name,
            attrs,
        )
        with self._lock:
            self.spans.append(span)

    def add_span_at(self, name: str, rel_start: float, duration: float,
                    thread: str = "", process: str = "",
                    **attrs: Any) -> None:
        """Append a span at an already-TIMELINE-RELATIVE start — how a
        stitched remote process's spans (whose perf_counter epoch means
        nothing here) land in this timeline after clock alignment."""
        if attrs:
            attrs = {k: v for k, v in attrs.items() if v not in (None, "")}
        span = Span(
            name, max(0.0, rel_start), max(0.0, duration),
            thread or threading.current_thread().name, attrs,
            process=process,
        )
        with self._lock:
            self.spans.append(span)

    def add_event(self, name: str, **attrs: Any) -> None:
        event = {
            "t": max(0.0, time.perf_counter() - self.started),
            "name": name,
            **{k: v for k, v in attrs.items() if v not in (None, "")},
        }
        with self._lock:
            self.events.append(event)

    def add_event_at(self, name: str, rel_t: float, process: str = "",
                     **attrs: Any) -> None:
        """Timeline-relative point event (the stitching twin of
        :meth:`add_span_at`)."""
        event = {
            "t": max(0.0, rel_t),
            "name": name,
            **({"process": process} if process else {}),
            **{k: v for k, v in attrs.items() if v not in (None, "")},
        }
        with self._lock:
            self.events.append(event)

    def finish(self, status: str = "", error: str = "") -> None:
        self.finished = time.perf_counter()
        if status:
            self.status = str(status)
        if error:
            self.error = str(error)

    # -- views ---------------------------------------------------------------
    @property
    def duration(self) -> float:
        end = self.finished if self.finished is not None else time.perf_counter()
        return max(0.0, end - self.started)

    def stage_seconds(self) -> Dict[str, float]:
        """Total seconds per stage name (repeated spans — chunked
        backfills, retries — sum)."""
        with self._lock:
            spans = list(self.spans)
        out: Dict[str, float] = {}
        for span in spans:
            out[span.name] = out.get(span.name, 0.0) + span.duration
        return out

    # parent stages CONTAIN other stages (score wraps the whole engine
    # call; route wraps every stitched worker stage), so counting them in
    # dominance would always blame the parent; they still appear in
    # stage_seconds for the full picture
    _PARENT_STAGES = frozenset({"score", "route"})

    def dominant_stage(self) -> str:
        stages = self.stage_seconds()
        leaves = {
            name: seconds for name, seconds in stages.items()
            if name not in self._PARENT_STAGES
        }
        # host-path machines record only the flat score span — fall back
        # to the parents rather than answering nothing
        stages = leaves or stages
        if not stages:
            return ""
        return max(stages.items(), key=lambda kv: kv[1])[0]

    def summary(self) -> Dict[str, Any]:
        """The /debug/requests listing row: everything an operator needs
        to pick which trace to open."""
        return {
            "trace_id": self.trace_id,
            "started": self.started_wall,
            "duration_ms": round(self.duration * 1000, 3),
            "status": self.status,
            "error": self.error,
            "dominant_stage": self.dominant_stage(),
            "stages_ms": {
                name: round(seconds * 1000, 3)
                for name, seconds in sorted(self.stage_seconds().items())
            },
            **self.meta,
        }

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            spans = list(self.spans)
            events = list(self.events)
        return {
            "trace_id": self.trace_id,
            "meta": dict(self.meta),
            "started": self.started_wall,
            "duration_ms": round(self.duration * 1000, 3),
            "status": self.status,
            "error": self.error,
            "dominant_stage": self.dominant_stage(),
            "stages_ms": {
                name: round(seconds * 1000, 3)
                for name, seconds in sorted(self.stage_seconds().items())
            },
            "spans": [
                {
                    "name": span.name,
                    "start_ms": round(span.start * 1000, 3),
                    "duration_ms": round(span.duration * 1000, 3),
                    "thread": span.thread,
                    **({"process": span.process} if span.process else {}),
                    **span.attrs,
                }
                for span in spans
            ],
            "events": events,
        }

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (the ``chrome://tracing`` / Perfetto
        format): complete (``ph: "X"``) events in microseconds, one track
        per recording thread, instant (``ph: "i"``) events for the point
        events. STITCHED spans (``Span.process`` set — another process's
        timeline merged in by the router) render as their own process
        lane (pid 2+), so one export shows router and worker side by
        side. ``json.dumps`` of the result is directly loadable."""
        base_us = self.started_wall * 1e6
        with self._lock:
            spans = list(self.spans)
            events = list(self.events)
        # process lanes: "" (this process) is always pid 1; every
        # distinct stitched process label gets its own pid after it
        remote = sorted(
            {span.process for span in spans if span.process}
            | {e["process"] for e in events if e.get("process")}
        )
        pids = {"": 1, **{name: i + 2 for i, name in enumerate(remote)}}
        local_label = str(
            self.meta.get("service") or f"gordo trace {self.trace_id}"
        )
        trace_events: List[Dict[str, Any]] = []
        for process, pid in sorted(pids.items(), key=lambda kv: kv[1]):
            trace_events.append({
                "ph": "M",
                "pid": pid,
                "name": "process_name",
                "args": {"name": process or local_label},
            })
        threads = sorted({(span.process, span.thread) for span in spans})
        tids = {key: i + 1 for i, key in enumerate(threads)}
        for (process, thread), tid in sorted(
            tids.items(), key=lambda kv: kv[1]
        ):
            trace_events.append({
                "ph": "M", "pid": pids[process], "tid": tid,
                "name": "thread_name", "args": {"name": thread},
            })
        for span in spans:
            trace_events.append({
                "ph": "X",
                "pid": pids[span.process],
                "tid": tids.get((span.process, span.thread), 0),
                "name": span.name,
                "cat": "stage",
                "ts": base_us + span.start * 1e6,
                "dur": span.duration * 1e6,
                "args": dict(span.attrs),
            })
        for event in events:
            args = {
                k: v for k, v in event.items()
                if k not in ("t", "name", "process")
            }
            trace_events.append({
                "ph": "i",
                "pid": pids.get(event.get("process", ""), 1),
                "tid": 0,
                "name": event["name"],
                "cat": "event",
                "ts": base_us + event["t"] * 1e6,
                "s": "p",  # process-scoped instant
                "args": args,
            })
        return {
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "otherData": {
                "trace_id": self.trace_id,
                "status": self.status,
                **{str(k): str(v) for k, v in self.meta.items()},
            },
        }


# -- context plumbing --------------------------------------------------------


class SpanContext(NamedTuple):
    """Explicit capture of (trace id, timeline) for crossing the seams
    contextvars do not survive: the engine's collector-thread handoff and
    the client's cross-thread asyncio submission."""

    trace_id: str
    timeline: Optional[Timeline]


EMPTY_CONTEXT = SpanContext("", None)


def capture() -> SpanContext:
    return SpanContext(tracing.get_trace_id(), _timeline.get())


@contextlib.contextmanager
def bind(ctx: SpanContext) -> Iterator[None]:
    """Re-bind a captured context on another thread/task: log records get
    the trace id back, and :func:`stage`/:func:`event` land in the right
    timeline. Safe with ``EMPTY_CONTEXT`` (binds nothing extra)."""
    trace_token = tracing.set_trace_id(ctx.trace_id) if ctx.trace_id else None
    timeline_token = _timeline.set(ctx.timeline)
    try:
        yield
    finally:
        _timeline.reset(timeline_token)
        if trace_token is not None:
            tracing.reset_trace_id(trace_token)


def current_timeline() -> Optional[Timeline]:
    return _timeline.get()


def begin(trace_id: str, **meta: Any):
    """Start a timeline and bind it to the current context. Returns
    ``(timeline, token)``; pass the token to :func:`end`."""
    timeline = Timeline(trace_id, **meta)
    return timeline, _timeline.set(timeline)


def end(token) -> None:
    """Unbind (the caller finishes/records the timeline itself — status
    is only known at the HTTP boundary)."""
    _timeline.reset(token)


@contextlib.contextmanager
def stage(name: str, **attrs: Any) -> Iterator[None]:
    """Record a named stage: always observes ``gordo_stage_seconds``,
    and appends a span when a timeline is bound."""
    timeline = _timeline.get()
    started = time.perf_counter()
    try:
        yield
    finally:
        duration = time.perf_counter() - started
        _stage_series(name).observe(duration)
        if timeline is not None:
            timeline.add_span(name, started, duration, **attrs)


def event(name: str, **attrs: Any) -> None:
    """Point event on the bound timeline (no-op without one)."""
    timeline = _timeline.get()
    if timeline is not None:
        timeline.add_event(name, **attrs)


def record_into(ctx: SpanContext, name: str, started: float,
                duration: float, **attrs: Any) -> None:
    """Record a span into a CAPTURED context's timeline from any thread —
    how the bucket leader and collector attribute dispatch/device/fetch
    time to each batched item's own request. Observes the aggregate
    histogram exactly once per call, like :func:`stage`."""
    _stage_series(name).observe(max(0.0, duration))
    if ctx.timeline is not None:
        ctx.timeline.add_span(name, started, duration, **attrs)


def event_into(ctx: SpanContext, name: str, **attrs: Any) -> None:
    if ctx.timeline is not None:
        ctx.timeline.add_event(name, **attrs)
