"""The port's observability copies against the JAX package's, on the CPU.

Span timelines, the flight recorder, stitching, exemplars, the machine
cardinality bound, the control ledger and the JSON log formatter are driven
the same way on both sides, with ``time.perf_counter`` and ``time.time``
replaced by one injected clock, so every timing is equal by construction and
every comparison is exact.
"""

import json
import logging
import os
import threading
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from gordo_components_tpu.observability import exposition as ref_exposition  # noqa: E402
from gordo_components_tpu.observability import flightrec as ref_flightrec  # noqa: E402
from gordo_components_tpu.observability import ledger as ref_ledger  # noqa: E402
from gordo_components_tpu.observability import logsetup as ref_logsetup  # noqa: E402
from gordo_components_tpu.observability import registry as ref_registry  # noqa: E402
from gordo_components_tpu.observability import spans as ref_spans  # noqa: E402
from gordo_components_tpu.observability import stitch as ref_stitch  # noqa: E402
from gordo_components_tpu.observability import tracing as ref_tracing  # noqa: E402

from gordo_components_tpu_torch.observability import (  # noqa: E402
    exposition,
    flightrec,
    ledger,
    logsetup,
    registry,
    spans,
    stitch,
    tracing,
)

PORT = (spans, flightrec, stitch, tracing)
REF = (ref_spans, ref_flightrec, ref_stitch, ref_tracing)


class _Clock:
    def __init__(self, start=100.0):
        self.now = start

    def __call__(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    """``perf_counter`` and ``time`` of the ``time`` module on one clock the
    test advances by hand (both packages call them through the module)."""
    fake = _Clock()
    monkeypatch.setattr(time, "perf_counter", fake)
    monkeypatch.setattr(time, "time", lambda: 1.7e9 + fake.now)
    return fake


# A script of timeline operations: (kind, name, advance before, duration)
_OPS = st.lists(st.tuples(
    st.sampled_from(["stage", "record_into", "event", "remote_span", "remote_event"]),
    st.sampled_from(list(ref_spans.STAGES) + ["custom"]),
    st.floats(0, 0.5, allow_nan=False),
    st.floats(0, 0.25, allow_nan=False),
), max_size=12)


def _play(package, clock, trace_id, ops, status="200", error=""):
    """Run ``ops`` on ``package``'s spans module under the clock; returns
    the finished timeline."""
    spans_mod = package[0]
    start = clock.now
    timeline, token = spans_mod.begin(trace_id, endpoint="anomaly", tenant="ops", empty=None)
    try:
        for i, (kind, name, advance, duration) in enumerate(ops):
            clock.now += advance
            if kind == "stage":
                with spans_mod.stage(name, machine=f"m{i}", blank=""):
                    clock.now += duration
            elif kind == "record_into":
                spans_mod.record_into(spans_mod.capture(), name, clock.now - duration, duration,
                                      batch=i)
            elif kind == "event":
                spans_mod.event(name, where=f"w{i}", overdue_s=duration)
            elif kind == "remote_span":
                timeline.add_span_at(name, clock.now - start, duration, thread="remote",
                                     process="worker-1", shard=i)
            else:
                timeline.add_event_at(name, clock.now - start, process="worker-2", n=i)
    finally:
        spans_mod.end(token)
    clock.now += 0.001
    timeline.finish(status=status, error=error)
    return timeline


@settings(max_examples=40, deadline=None)
@given(ops=_OPS)
def test_timeline_views_equal_the_reference(ops):
    """to_dict, to_chrome_trace, summary, stage totals and dominance of the
    same spans under the same clock are equal (exact)."""
    fake = _Clock()
    saved = time.perf_counter, time.time
    time.perf_counter, time.time = fake, lambda: 1.7e9 + fake.now
    try:
        ours = _play(PORT, fake, "feed0000beef0000", ops)
        fake.now = 100.0
        ref = _play(REF, fake, "feed0000beef0000", ops)
    finally:
        time.perf_counter, time.time = saved
    assert ours.to_dict() == ref.to_dict()
    assert ours.to_chrome_trace() == ref.to_chrome_trace()
    assert ours.summary() == ref.summary()
    assert ours.stage_seconds() == ref.stage_seconds()
    assert ours.dominant_stage() == ref.dominant_stage()
    json.loads(json.dumps(ours.to_chrome_trace()))  # loadable trace-event JSON


def test_span_context_crosses_threads_as_the_reference(clock):
    """A context captured on one thread and bound on another restores the
    trace id (what the log record factory stamps) and routes stages into the
    right timeline."""
    for spans_mod, _, _, tracing_mod in (PORT, REF):
        with tracing_mod.trace("abcd000011112222"):
            timeline, token = spans_mod.begin("abcd000011112222")
            try:
                ctx = spans_mod.capture()
            finally:
                spans_mod.end(token)
        seen = []

        def far_side():
            assert tracing_mod.get_trace_id() == ""
            with spans_mod.bind(ctx):
                seen.append(tracing_mod.get_trace_id())
                with spans_mod.stage("fetch"):
                    clock.now += 0.01
            seen.append(tracing_mod.get_trace_id())
            with spans_mod.bind(spans_mod.EMPTY_CONTEXT):
                spans_mod.event("nowhere")

        thread = threading.Thread(target=far_side, name="far")
        thread.start()
        thread.join(timeout=10)
        assert not thread.is_alive()
        assert seen == ["abcd000011112222", ""]
        assert [(s.name, s.thread) for s in timeline.spans] == [("fetch", "far")]
        assert timeline.events == []


def test_tracing_helpers_follow_the_reference(clock):
    for tracing_mod in (tracing, ref_tracing):
        assert tracing_mod.get_trace_id() == "" and len(tracing_mod.current_or_new()) == 16
        with tracing_mod.trace() as tid:
            assert tracing_mod.current_or_new() == tid and len(tid) == 16
            with tracing_mod.span("unit") as sid:
                assert tracing_mod.get_span_id() == sid and len(sid) == 8
            assert tracing_mod.get_span_id() == ""
        assert tracing_mod.get_trace_id() == ""


@pytest.mark.parametrize("keep, slow_keep, error_keep", [(4, 2, 2), (1, 1, 1), (8, 3, 5)])
def test_flight_recorder_retains_what_the_reference_retains(clock, keep, slow_keep, error_keep):
    durations = [0.03, 0.5, 0.01, 0.2, 0.9, 0.05, 0.4, 0.02, 0.7, 0.06, 0.3, 0.08]
    views = []
    for package in (PORT, REF):
        recorder = package[1].FlightRecorder(keep=keep, slow_keep=slow_keep,
                                             error_keep=error_keep, enabled=True)
        clock.now = 100.0
        for i, duration in enumerate(durations):
            timeline = package[0].Timeline(f"{i:016x}", endpoint="anomaly")
            with package[0].bind(package[0].SpanContext("", timeline)):
                package[0].record_into(package[0].capture(), "fetch", clock.now, duration)
            clock.now += duration
            if i % 3 == 2:
                timeline.finish(status="503", error="HTTP 503")
            recorder.record(timeline)  # an unfinished one is finished here
        recorder.set_enabled(False)
        recorder.record(package[0].Timeline("dropped"))
        views.append((recorder.summaries(limit=3), recorder.summaries(limit=0),
                      recorder.slowest().trace_id,
                      [recorder.get(f"{i:016x}") is not None for i in range(len(durations))]))
        recorder.clear()
        assert recorder.summaries()["recorded"] == 0
    assert views[0] == views[1]


def test_flight_recorder_knobs_are_the_references(monkeypatch):
    for name, value in (("GORDO_FLIGHTREC", "0"), ("GORDO_FLIGHTREC_KEEP", "7"),
                        ("GORDO_FLIGHTREC_SLOW_KEEP", "junk"), ("GORDO_FLIGHTREC_ERROR_KEEP", "-3")):
        monkeypatch.setenv(name, value)
    ours, ref = flightrec.FlightRecorder(), ref_flightrec.FlightRecorder()
    assert (ours.enabled, ours.keep, ours.slow_keep, ours.error_keep) == (
        ref.enabled, ref.keep, ref.slow_keep, ref.error_keep) == (False, 7, 32, 1)


@pytest.mark.parametrize("cap", [None, 256, 600, 100000])
def test_encode_timeline_gives_the_reference_bytes(clock, cap):
    ops = [("stage", name, 0.01, 0.02) for name in ref_spans.STAGES] * 3
    ours = _play(PORT, clock, "0123456789abcdef", ops)
    clock.now = 100.0
    ref = _play(REF, clock, "0123456789abcdef", ops)
    assert stitch.encode_timeline(ours, cap) == ref_stitch.encode_timeline(ref, cap)
    encoded, size = stitch.encode_timeline(ours, cap)
    if encoded is not None:
        assert stitch.decode_timeline(encoded) == ref_stitch.decode_timeline(encoded) == \
            json.loads(json.dumps(ours.to_dict(), default=str))
    else:
        assert size > (cap or stitch.max_bytes())


def test_timeline_size_cap_knob(monkeypatch):
    for value in ("junk", "12", "20000"):
        monkeypatch.setenv("GORDO_TIMELINE_MAX_BYTES", value)
        assert stitch.max_bytes() == ref_stitch.max_bytes()


@pytest.mark.parametrize("value", ["", "not base64!", "bm90IGpzb24=", "WzEsIDJd", "eyJhIjogMX0="])
def test_decode_timeline_refuses_what_the_reference_refuses(value):
    with pytest.raises(ValueError):
        ref_stitch.decode_timeline(value)
    with pytest.raises(ValueError):
        stitch.decode_timeline(value)


@settings(max_examples=60, deadline=None)
@given(started=st.floats(-5, 5, allow_nan=False), duration_ms=st.floats(0, 3000, allow_nan=False),
       window=st.tuples(st.floats(0, 2, allow_nan=False), st.floats(0, 3, allow_nan=False)))
def test_align_offset_equals_the_reference(started, duration_ms, window):
    remote = {"started": 1000.0 + started, "duration_ms": duration_ms}
    start, length = window
    assert stitch.align_offset(1000.0, remote, start, start + length) == \
        ref_stitch.align_offset(1000.0, remote, start, start + length)


def test_merge_remote_gives_the_reference_timeline(clock):
    ops = [("stage", "dispatch", 0.0, 0.02), ("event", "deadline_expired", 0.01, 0.0),
           ("stage", "fetch", 0.0, 0.03)]
    remote = _play(PORT, clock, "aaaabbbbccccdddd", ops).to_dict()
    remote["spans"].append({"name": "broken", "start_ms": "x"})  # skipped, not fatal
    remote["events"].append({"t": 1.0})  # no name: skipped
    merged = []
    for package in (PORT, REF):
        clock.now = 90.0
        local = package[0].Timeline("aaaabbbbccccdddd", service="router")
        n = package[2].merge_remote(local, remote, 0.001, 0.5, "worker-0")
        local.finish(status="200")
        merged.append((n, local.to_dict(), local.to_chrome_trace()))
    assert merged[0] == merged[1] and merged[0][0] == 2


# -- exemplars and the cardinality bound ------------------------------------------
def _observe_traced(registry_mod, tracing_mod):
    reg = registry_mod.Registry()
    hist = reg.histogram("ex_seconds", "latency", labels=("stage",), buckets=(0.01, 0.1, 1.0))
    counter = reg.counter("ex_total", "events", labels=("stage",))
    with tracing_mod.trace("feedface00000000"):
        hist.labels("fetch").observe(0.05)
        hist.labels("fetch").observe(0.005)
        counter.labels("fetch").inc()
    with tracing_mod.trace("beefbeef00000000"):
        hist.labels("fetch").observe(0.07)  # the newest wins its bucket
    hist.labels("dispatch").observe(0.5)  # untraced: no exemplar
    return reg


def test_exemplar_render_is_byte_equal_and_parses_alike(clock):
    ours = exposition.render_prometheus(_observe_traced(registry, tracing), exemplars=True)
    ref = ref_exposition.render_prometheus(_observe_traced(ref_registry, ref_tracing),
                                           exemplars=True)
    assert ours == ref
    assert ' # {trace_id="beefbeef00000000"} 0.07 ' in ours
    assert "feedface" in ours and "trace_id" not in exposition.render_prometheus(
        _observe_traced(registry, tracing))
    parsed = exposition.parse_prometheus_text(ours, return_exemplars=True)
    assert parsed == ref_exposition.parse_prometheus_text(ours, return_exemplars=True)
    assert exposition.parse_prometheus_text(ours, return_meta=True) == \
        ref_exposition.parse_prometheus_text(ours, return_meta=True)
    exemplars = parsed[1]["ex_seconds_bucket"]
    assert [(labels["le"], e["labels"]["trace_id"]) for labels, e in exemplars] == [
        ("0.01", "feedface00000000"), ("0.1", "beefbeef00000000")]


_HASH_LINES = (
    "# TYPE errs_total counter\n"
    'errs_total{err="bad # thing"} 1\n'
    'errs_total{err="fake # {trace_id=\\"x\\"} 1"} 2\n'
)


@pytest.mark.parametrize("text", [
    "# TYPE h histogram\nh_bucket{le=\"+Inf\"} 1 # not an exemplar\nh_sum 1.0\nh_count 1\n",
    '# TYPE g gauge\ng 1 # {trace_id="abc"} 1\n',
    "# TYPE h histogram\n" + 'h_bucket{le="+Inf"} 1 # {trace_id="' + "x" * 200 + '"} 1\n'
    + "h_sum 1.0\nh_count 1\n",
    '# TYPE h histogram\nh_bucket{le="+Inf"} 1 # {} 1\nh_sum 1.0\nh_count 1\n',
    '# TYPE h histogram\nh_bucket{le="+Inf"} 1 # {trace_id=abc} 1\nh_sum 1.0\nh_count 1\n',
])
def test_exemplar_parser_rejects_what_the_reference_rejects(text):
    with pytest.raises(ValueError):
        ref_exposition.parse_prometheus_text(text)
    with pytest.raises(ValueError):
        exposition.parse_prometheus_text(text)


@pytest.mark.parametrize("text", [
    _HASH_LINES,
    '# TYPE c_total counter\nc_total 3 # {trace_id="abc"} 1 1700000000.0\n',
])
def test_exemplar_parser_accepts_what_the_reference_accepts(text):
    assert exposition.parse_prometheus_text(text, return_exemplars=True) == \
        ref_exposition.parse_prometheus_text(text, return_exemplars=True)


@pytest.mark.parametrize("cap", ["0", "2", "3", "64"])
def test_machine_cardinality_bound_renders_as_the_reference(monkeypatch, clock, cap):
    monkeypatch.setenv("GORDO_METRICS_MACHINE_CARDINALITY", cap)
    monkeypatch.setattr(ref_registry, "_traffic_topk_provider", None)
    outputs = []
    for registry_mod, exposition_mod, tracing_mod in (
            (registry, exposition, tracing), (ref_registry, ref_exposition, ref_tracing)):
        reg = registry_mod.Registry()
        counter = reg.counter("m_total", labels=("machine", "status"))
        gauge = reg.gauge("m_seconds", labels=("machine",))
        hist = reg.histogram("m_latency", labels=("machine",), buckets=(0.1, 1.0))
        for i, name in enumerate(["a", "b", "c", "other", "d", "e"]):
            counter.labels(name, "200").inc(10 - i)
            gauge.labels(name).set(i * 0.5)
            with tracing_mod.trace(f"{i:016x}"):
                for _ in range(6 - i):
                    hist.labels(name).observe(0.05 * (i + 1))
        outputs.append((exposition_mod.render_prometheus(reg, exemplars=True), reg.snapshot()))
    assert outputs[0] == outputs[1]


# -- the control ledger -------------------------------------------------------------
def _emit_script(ledger_mod, directory, wall, segment_limit, budget):
    sink = ledger_mod.ControlLedger(directory, wall=wall, segment_limit=segment_limit,
                                    budget=budget)
    for i in range(40):
        wall.now += 0.25
        sink.emit(actor=ledger_mod.ACTORS[i % len(ledger_mod.ACTORS)], action=f"step-{i}",
                  target=f"m{i % 3}", before=i, after=i + 1 if i % 2 else None,
                  reason="x" * (i % 7), trace_id="t" if i % 5 == 0 else "",
                  revision={"n": i} if i % 4 == 0 else None)
    return sink


def _segments(directory):
    return {name: open(os.path.join(directory, name)).read()
            for name in sorted(os.listdir(directory))}


@pytest.mark.parametrize("durable", [True, False])
def test_ledger_records_rotation_and_budget_follow_the_reference(tmp_path, durable):
    views = []
    for side, ledger_mod in (("port", ledger), ("ref", ref_ledger)):
        directory = str(tmp_path / side) if durable else None
        sink = _emit_script(ledger_mod, directory, _Clock(1.7e9), 4096, 65536)
        snap = sink.snapshot()
        view = [sink.recent(), sink.recent(window=3.0), sink.recent(limit=4), snap]
        sink.close()
        if durable:
            view.append(_segments(directory))
            reloaded = ledger_mod.ControlLedger(directory, wall=_Clock(1.7e9 + 100),
                                                segment_limit=4096, budget=65536)
            view.append((reloaded.recent(), reloaded.snapshot()["next_seq"]))
            reloaded.close()
        views.append(view)
    assert views[0] == views[1]
    assert views[0][3]["rotations" if durable else "segments"] >= 1


def test_ledger_tolerates_a_torn_tail_and_drops_when_disabled(tmp_path, monkeypatch):
    views = []
    for side, ledger_mod in (("port", ledger), ("ref", ref_ledger)):
        directory = tmp_path / side
        sink = _emit_script(ledger_mod, str(directory), _Clock(1.7e9), 1 << 20, 1 << 20)
        sink.close()
        segment = sorted(directory.iterdir())[-1]
        segment.write_text(segment.read_text() + '{"schema": "gordo-con')  # torn append
        reloaded = ledger_mod.ControlLedger(str(directory), wall=_Clock(1.7e9))
        monkeypatch.setenv("GORDO_LEDGER", "0")
        assert reloaded.emit(actor="qos", action="shed-level") is None
        monkeypatch.delenv("GORDO_LEDGER")
        views.append((len(reloaded.recent()), reloaded.snapshot()))
        reloaded.close()
    assert views[0] == views[1] and views[0][0] == 40


def test_ledger_configure_adopts_memory_events_and_is_idempotent(tmp_path, monkeypatch):
    views = []
    for side, ledger_mod in (("port", ledger), ("ref", ref_ledger)):
        monkeypatch.setattr(ledger_mod, "LEDGER", ledger_mod.ControlLedger(wall=_Clock(5.0)))
        ledger_mod.emit("faults", "inject-plan", target="model-load:m", reason="error")
        durable = ledger_mod.configure(str(tmp_path / side), wall=_Clock(9.0))
        assert ledger_mod.configure(str(tmp_path / side)) is durable
        ledger_mod.emit("quarantine", "quarantine", target="m", reason="load: boom")
        views.append([{k: v for k, v in e.items()} for e in durable.recent()])
        durable.close()
    assert views[0] == views[1]
    assert [(e["seq"], e["ts"], e["action"]) for e in views[0]] == [
        (0, 5.0, "inject-plan"), (1, 9.0, "quarantine")]


_EVENTS = [
    {"schema": "gordo-control-event/v1", "seq": 1, "ts": 1.5, "actor": "qos", "action": "a",
     "target": ""},
    {"schema": "v0", "seq": "1", "ts": "now", "actor": "martian", "action": "", "target": 3,
     "extra": 1},
    {"seq": 2},
    ["not", "a", "dict"],
    {"schema": "gordo-control-event/v1", "seq": 1, "ts": 1, "actor": "breaker", "action": "open",
     "target": "m", "before": "closed", "after": "open", "reason": "r", "trace_id": "t",
     "revision": 3},
]


@pytest.mark.parametrize("event", _EVENTS)
def test_validate_event_verdicts_are_the_references(event):
    assert ledger.validate_event(event) == ref_ledger.validate_event(event)


@pytest.mark.parametrize("name, value", [("GORDO_LEDGER_MB", "0.5"), ("GORDO_LEDGER_MB", "x"),
                                         ("GORDO_LEDGER_SEGMENT_KB", "1"),
                                         ("GORDO_LEDGER_SEGMENT_KB", "64")])
def test_ledger_knobs_are_the_references(monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    assert (ledger.byte_budget(), ledger.segment_bytes()) == (
        ref_ledger.byte_budget(), ref_ledger.segment_bytes())


# -- logs ----------------------------------------------------------------------------
@pytest.mark.parametrize("trace_id, span_id, exc", [("", "", False), ("abc", "", False),
                                                     ("abc", "def", True)])
def test_json_formatter_gives_the_reference_fields(trace_id, span_id, exc):
    record = logging.LogRecord("gordo.test", logging.WARNING, __file__, 7, "hello %s", ("you",),
                               None)
    record.created = 1.7e9
    record.trace_id, record.span_id = trace_id, span_id
    if exc:
        try:
            raise ValueError("boom")
        except ValueError:
            import sys

            record.exc_info = sys.exc_info()
    assert json.loads(logsetup.JsonFormatter().format(record)) == json.loads(
        ref_logsetup.JsonFormatter().format(record))


def test_configure_logging_refuses_an_unknown_format():
    for module in (logsetup, ref_logsetup):
        with pytest.raises(ValueError, match="'text' or 'json'"):
            module.configure_logging("INFO", "xml")
    assert logsetup.TEXT_FORMAT == ref_logsetup.TEXT_FORMAT


def test_log_record_factories_of_both_packages_compose():
    """Each package's factory wraps the other's: a record made under one
    package's trace carries that trace id whichever factory is outermost
    (the port's leaves an id the inner factory stamped when it has none)."""
    saved = logging.getLogRecordFactory()
    saved_flags = (tracing._factory_installed, ref_tracing._factory_installed)
    try:
        logging.setLogRecordFactory(logging.LogRecord)
        tracing._factory_installed = ref_tracing._factory_installed = False
        ref_tracing.install_log_record_factory()
        tracing.install_log_record_factory()  # the port's outermost
        logger = logging.getLogger("gordo-test-compose")

        def trace_of(make):
            records = []
            handler = logging.Handler()
            handler.emit = records.append
            logger.addHandler(handler)
            try:
                make()
            finally:
                logger.removeHandler(handler)
            return records[0].trace_id

        def logged_under(module, trace_id):
            def make():
                token = module.set_trace_id(trace_id)
                try:
                    logger.warning("x")
                finally:
                    module.reset_trace_id(token)
            return make

        assert trace_of(logged_under(ref_tracing, "ref0000000000001")) == "ref0000000000001"
        assert trace_of(logged_under(tracing, "port000000000001")) == "port000000000001"
        assert trace_of(lambda: logger.warning("x")) == ""
    finally:
        logging.setLogRecordFactory(saved)
        tracing._factory_installed, ref_tracing._factory_installed = saved_flags
