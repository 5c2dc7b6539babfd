"""The port's QoS and admission copies against the JAX package's, on the CPU.

Tenant tables parse to the same specs and the same errors, token buckets
admit and refuse the same sequence under one injected clock, the
weighted-fair interleave gives the same order, the class watermark tables
are equal, and a scripted admission sequence (quotas, classes, the shed
ladder, close) gives the same admits, sheds, levels and ``stats()``. Every
comparison is exact.
"""

import dataclasses

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from gordo_components_tpu.observability import ledger as ref_ledger  # noqa: E402
from gordo_components_tpu.resilience import admission as ref_admission  # noqa: E402
from gordo_components_tpu.resilience import qos as ref_qos  # noqa: E402

from gordo_components_tpu_torch.observability import ledger  # noqa: E402
from gordo_components_tpu_torch.resilience import admission, qos  # noqa: E402


class _Clock:
    def __init__(self, start=50.0):
        self.now = start

    def __call__(self):
        return self.now


def _parse(module, spec):
    try:
        return [dataclasses.asdict(t) for t in module.parse_tenants(spec)]
    except ValueError as exc:
        return ("error", str(exc))


_TOKENS = st.sampled_from(["dash", "etl", "tiny", "", " x ", "interactive", "bulk", "standard",
                           "Standard", "gold", "1", "0.5", "-2", "abc", "50", "s3cret", "100"])
_ENTRIES = st.lists(_TOKENS, min_size=0, max_size=6).map(":".join)


@settings(max_examples=200, deadline=None)
@given(entries=st.lists(_ENTRIES, max_size=4), sep=st.sampled_from([";", ",", " ; "]))
def test_parse_tenants_gives_the_reference_specs_and_errors(entries, sep):
    spec = sep.join(entries)
    assert _parse(qos, spec) == _parse(ref_qos, spec)


@pytest.mark.parametrize("spec", [None, "", "  ", "dash:interactive;etl:bulk:50:100:s3cret",
                                  "a:gold", "a;a", ":bulk", "a:bulk:fast", "a:bulk:1:wide",
                                  "default:interactive;b", "a:standard:0:0:k"])
def test_parse_tenants_edge_cases(spec):
    assert _parse(qos, spec) == _parse(ref_qos, spec)


@settings(max_examples=100, deadline=None)
@given(rate=st.sampled_from([0.0, 0.5, 1.0, 3.0, 50.0]),
       burst=st.sampled_from([0.0, 1.0, 2.0, 5.0]),
       steps=st.lists(st.tuples(st.floats(0, 2, allow_nan=False), st.sampled_from([1.0, 2.0])),
                      max_size=30))
def test_token_bucket_admits_and_refuses_as_the_reference(rate, burst, steps):
    clock = _Clock()
    ours, ref = qos.TokenBucket(rate, burst, clock), ref_qos.TokenBucket(rate, burst, clock)
    for advance, n in steps:
        clock.now += advance
        assert ours.take(n) == ref.take(n)
        assert ours.seconds_until(n) == ref.seconds_until(n)
        assert ours.tokens == ref.tokens


@settings(max_examples=200, deadline=None)
@given(classes=st.lists(st.sampled_from(list(ref_qos.CLASSES) + ["unknown"]), max_size=40),
       weights=st.one_of(st.none(), st.fixed_dictionaries({
           k: st.floats(0.1, 20, allow_nan=False) for k in ref_qos.CLASSES})))
def test_weighted_interleave_gives_the_reference_order(classes, weights):
    items = list(enumerate(classes))
    ours = qos.weighted_interleave(items, lambda it: it[1], weights)
    assert ours == ref_qos.weighted_interleave(items, lambda it: it[1], weights)
    assert sorted(ours) == items  # a permutation, arrival order kept per class
    for klass in set(classes):
        assert [i for i, k in ours if k == klass] == [i for i, k in items if k == klass]


@pytest.mark.parametrize("value", ["", "interactive=16,bulk=2", "standard=0.2;bulk=x",
                                   "gold=3,=4,interactive", "BULK=5"])
def test_class_weights_knob_is_the_references(monkeypatch, value):
    monkeypatch.setenv("GORDO_QOS_WEIGHTS", value)
    assert qos.class_weights() == ref_qos.class_weights()


@pytest.mark.parametrize("value", [None, "interactive", "BULK", "gold"])
def test_default_class_knob_is_the_references(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("GORDO_QOS_DEFAULT_CLASS", raising=False)
    else:
        monkeypatch.setenv("GORDO_QOS_DEFAULT_CLASS", value)
    assert qos.default_class() == ref_qos.default_class()
    assert qos.TenantTable().default.klass == ref_qos.TenantTable().default.klass


def test_class_limit_and_queue_limit_tables_are_the_references():
    for klass in list(ref_qos.CLASSES) + ["unknown"]:
        for n in range(0, 70):
            assert qos.queue_limit(n, klass) == ref_qos.queue_limit(n, klass)
            for level in range(-1, ref_qos.SHED_MAX + 2):
                if n:
                    assert qos.class_limit(n, klass, level) == ref_qos.class_limit(n, klass, level)
    assert (qos.CLASSES, qos.SHED_MAX, qos.TENANT_HEADER, qos.DEFAULT_TENANT) == (
        ref_qos.CLASSES, ref_qos.SHED_MAX, ref_qos.TENANT_HEADER, ref_qos.DEFAULT_TENANT)


def test_tenant_table_resolves_and_snapshots_as_the_reference():
    spec = "dash:interactive;etl:bulk:2:3:s3cret;tiny:standard:1:1"
    clock = _Clock()
    ours = qos.TenantTable(qos.parse_tenants(spec), clock)
    ref = ref_qos.TenantTable(ref_qos.parse_tenants(spec), clock)
    headers = [None, "", "dash", "s3cret", "etl", " tiny ", "nobody"] + [
        f"spray-{i % 90}" for i in range(300)]
    for i, header in enumerate(headers):
        clock.now += 0.05
        a, b = ours.resolve(header), ref.resolve(header)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert ours.take(a) == ref.take(b)
        if i % 50 == 0:
            assert ours.snapshot() == ref.snapshot()
    assert ours.snapshot() == ref.snapshot() and len(ours) == len(ref) == 4


def test_tenant_context_follows_the_reference():
    for module in (qos, ref_qos):
        assert module.current() is None and module.current_class() == "standard"
        spec = module.TenantSpec("dash", klass="interactive", rate=2.0)
        token = module.set_current(spec)
        try:
            assert module.current() is spec and module.current_class() == "interactive"
            bulk = module.as_class(spec, "bulk")
            assert (bulk.name, bulk.klass, bulk.rate) == ("dash", "bulk", 2.0)
            assert module.as_class(spec, "interactive") is spec
        finally:
            module.reset(token)
        assert module.current() is None


# -- the admission gate ------------------------------------------------------------
_TENANTS = "dash:interactive;etl:bulk;tiny:standard:1:2"


def _script(module, qos_module, clock):
    """A fixed admission sequence; returns every outcome and stats()."""
    table = qos_module.TenantTable(qos_module.parse_tenants(_TENANTS), clock)
    gate = module.AdmissionController(max_inflight=4, max_queue=0, queue_timeout=0.01,
                                      tenants=table, clock=clock)
    specs = {name: table.resolve(name) for name in ("dash", "etl", "tiny", None)}
    held, trace = [], []

    def attempt(name):
        token = qos_module.set_current(specs[name])
        try:
            held.append(gate.admit())
            trace.append(("admit", name))
        except module.QuotaExceeded as exc:
            trace.append(("quota", name, exc.tenant, round(exc.retry_after, 6)))
        except module.AdmissionRejected as exc:
            trace.append(("shed", name, str(exc), round(exc.retry_after, 6)))
        finally:
            qos_module.reset(token)

    for name in ("etl", "etl", "etl", "etl", "dash", "tiny", "tiny", "tiny", None):
        attempt(name)
    trace.append(("stats", gate.stats()))
    for _ in range(3):
        clock.now += 0.25
        held.pop(0).release()
    trace.append(("stats", gate.stats()))
    for level in (2, 8, 8, 20, 0):
        trace.append(("level", gate.set_shed_level(level), gate.shed_level))
        attempt("etl")
    clock.now += 1.0
    attempt("tiny")
    attempt(None)
    gate.close("draining")
    attempt("dash")
    trace.append(("stats", gate.stats()))
    for slot in held:
        slot.release()
    trace.append(("drained", gate.drain(0.1), gate.stats()))
    return trace


def test_scripted_admission_follows_the_reference(monkeypatch):
    monkeypatch.setattr(ledger, "LEDGER", ledger.ControlLedger())
    monkeypatch.setattr(ref_ledger, "LEDGER", ref_ledger.ControlLedger())
    ours = _script(admission, qos, _Clock())
    ref = _script(ref_admission, ref_qos, _Clock())
    assert ours == ref
    assert [e for e in ours if e[0] == "quota"]
    assert [e for e in ours if e[0] == "shed"]
    # the shed ladder's moves are control events, as the reference's
    moves = [(e["before"], e["after"]) for e in ledger.LEDGER.recent()
             if (e["actor"], e["action"]) == ("qos", "shed-level")]
    assert moves == [(e["before"], e["after"]) for e in ref_ledger.LEDGER.recent()
                     if (e["actor"], e["action"]) == ("qos", "shed-level")]
    assert moves == [(0, 2), (2, 8), (8, 0)]


def test_interactive_waiter_takes_the_freed_slot_before_standard():
    """A freed slot goes to the highest class waiting, as the reference's."""
    import threading
    import time

    for module, qos_module in ((admission, qos), (ref_admission, ref_qos)):
        gate = module.AdmissionController(max_inflight=1, max_queue=8, queue_timeout=10.0)
        held = gate.admit()
        order = []

        def wait(klass):
            token = qos_module.set_current(qos_module.TenantSpec(klass, klass=klass))
            try:
                with gate.admit():
                    order.append(klass)
            finally:
                qos_module.reset(token)

        threads = []
        for klass in ("standard", "interactive"):
            t = threading.Thread(target=wait, args=(klass,))
            t.start()
            threads.append(t)
            deadline_at = time.monotonic() + 10
            while gate.stats()["queue_by_class"][klass] == 0:
                assert time.monotonic() < deadline_at
                time.sleep(0.001)
        held.release()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert order == ["interactive", "standard"]
