"""The port's megabatch residency tier against the reference's (mirrors
``tests/test_megabatch.py:129-147`` and ``:304-620``).

Six dense machines of one architecture (one reference fit, its weights
scaled per machine, dumped by the reference and loaded by the port) run
through the reference's ``ServingEngine`` and the port's on the CPU, the
same requests in the same order. Residency is a pure function of that
order, so the resident set, the promotions, demotions, backoff deferrals,
evictions and pins must be the same on both sides after every step. Scores
agree within atol 1e-4 (the stacked engine's parity bound,
``tests/test_torch_engine_stacked.py``); within the port, a resident
(mega) dispatch equals the cold dispatch of the same batch bit for bit,
as the reference's test holds its own.
"""

import copy
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu.serializer import dump as ref_dump  # noqa: E402
from gordo_components_tpu.server import engine as ref_engine_mod  # noqa: E402
from gordo_components_tpu.server.engine import ServingEngine as RefEngine  # noqa: E402

from gordo_components_tpu_torch.autopilot import build_server_autopilot  # noqa: E402
from gordo_components_tpu_torch.observability.registry import REGISTRY  # noqa: E402
from gordo_components_tpu_torch.parallel.mesh import fleet_mesh  # noqa: E402
from gordo_components_tpu_torch.serializer import load  # noqa: E402
from gordo_components_tpu_torch.server import engine as engine_mod  # noqa: E402
from gordo_components_tpu_torch.server.engine import ServingEngine, _Item  # noqa: E402
from gordo_components_tpu_torch.server.server import ModelServer  # noqa: E402

from test_torch_megabatch import _held_bucket  # noqa: E402
from test_torch_server_seams import TAGS, _fit  # noqa: E402

# module-wide thread-hygiene gate (tests/conftest.py)
pytestmark = pytest.mark.usefixtures("thread_hygiene")

N_MACHINES = 6
JOIN_S = 120
X = (np.random.default_rng(5).normal(size=(64, len(TAGS))) * 2 + 4).astype(np.float32)


def replicas(n, seed=0):
    """``n`` reference machines of one architecture: one fit, each copy's
    weights scaled by its own factor."""
    proto = _fit(seed)
    models = {}
    for i in range(n):
        model = copy.deepcopy(proto)
        est = model.base_estimator.regressor.steps[-1][1]
        factor = np.float32(1.0 + 0.01 * (i + 1))

        def scale(tree):
            if isinstance(tree, dict):
                return {key: scale(value) for key, value in tree.items()}
            return np.asarray(tree) * factor

        est.params_ = scale(est.params_)
        models[f"machine-{i:02d}"] = model
    return models


def dump_and_load(models, root):
    """The reference's artifacts under ``root`` and the port's models
    loaded from them on the CPU."""
    for name, model in models.items():
        ref_dump(model, str(root / name), metadata={"dataset": {"tag_list": TAGS}})
    return {name: load(str(root / name), device="cpu") for name in models}


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    root = tmp_path_factory.mktemp("residency")
    ref_models = replicas(N_MACHINES)
    return ref_models, dump_and_load(ref_models, root), root


def _engines(fleet, **kwargs):
    ref_models, port_models, _ = fleet
    return (ServingEngine(port_models, device="cpu", **kwargs), RefEngine(ref_models, **kwargs))


def _bits(result):
    return tuple(np.asarray(arr).tobytes() for arr in result)


def _assert_parity(ours, ref):
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4, rtol=0)


def _residency(engine):
    """The bucket's resident machines (by index) and its pins."""
    bucket = engine._buckets[0]
    with bucket._mega_lock:
        return sorted(bucket._mega_slots), sorted(bucket._mega_pinned)


MEGA_EVENTS = ("promote", "evict", "demote", "backoff_defer", "residency_resize",
               "fallback_cold", "retry_isolated")


def events(registry, series, names):
    """A counter's value by its one label (0 where it never moved)."""
    values = registry.counter(series, "", labels=("event",)).collect()
    return {name: values.get((name,), 0.0) for name in names}


def _mega_events():
    return events(REGISTRY, "gordo_engine_megabatch_events_total", MEGA_EVENTS)


def _ref_mega_events():
    from gordo_components_tpu.observability.registry import REGISTRY as REF_REGISTRY

    return events(REF_REGISTRY, "gordo_engine_megabatch_events_total", MEGA_EVENTS)


def _delta(after, before):
    return {key: after[key] - before[key] for key in after}


def _both(pair, name, X=X):
    """The same request through both engines, each quiesced after it (the
    promotion rides the fetch stage); the port's answer."""
    ours, ref = pair
    scored = ours.anomaly(name, X)
    _assert_parity(scored, ref.anomaly(name, X))
    ours.quiesce()
    ref.quiesce()
    return scored


def _close(pair):
    for engine in pair:
        engine.close()


@pytest.fixture
def held_events():
    """The port's and the reference's megabatch event counters, read
    before a test; ``delta()`` gives both moves."""
    before = (_mega_events(), _ref_mega_events())

    def delta():
        return _delta(_mega_events(), before[0]), _delta(_ref_mega_events(), before[1])

    return delta


# -- knobs ---------------------------------------------------------------------


@pytest.mark.parametrize("raw", [None, "0", "false", "OFF", "no", "1", "yes", "garbage"])
def test_megabatch_switch_parses_as_the_reference(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("GORDO_MEGABATCH", raising=False)
    else:
        monkeypatch.setenv("GORDO_MEGABATCH", raw)
    assert engine_mod._megabatch_enabled() == ref_engine_mod._megabatch_enabled()
    assert engine_mod._megabatch_enabled() is (raw not in ("0", "false", "OFF", "no"))


@pytest.mark.parametrize("raw,cap", [(None, 128), ("12", 12), ("-3", 0), ("garbage", 128)])
def test_residency_cap_parses_as_the_reference(monkeypatch, raw, cap):
    if raw is None:
        monkeypatch.delenv("GORDO_MEGABATCH_RESIDENCY", raising=False)
    else:
        monkeypatch.setenv("GORDO_MEGABATCH_RESIDENCY", raw)
    assert engine_mod._megabatch_residency_cap() == ref_engine_mod._megabatch_residency_cap() == cap


def test_engine_reads_the_switches_from_the_environment(monkeypatch, fleet):
    monkeypatch.setenv("GORDO_MEGABATCH", "off")
    monkeypatch.setenv("GORDO_FILL_WINDOW_US", "500")
    pair = _engines(fleet)
    try:
        for engine in pair:
            stats = engine.stats()["megabatch"]
            assert not stats["enabled"] and stats["fill_window_us"] == 0
            assert not engine._buckets[0]._mega_enabled
        # megabatching off: every batch routes cold, and answers agree
        scored = _both(pair, "machine-00")
        assert pair[0].stats()["megabatch"]["requests"] == 0
        assert pair[0].stats()["batched_requests"] == 1
        assert np.isfinite(scored.total_anomaly_score).all()
        monkeypatch.setenv("GORDO_MEGABATCH", "on")
        monkeypatch.setenv("GORDO_MEGABATCH_RESIDENCY", "0")  # 0 disables it too
        off = _engines(fleet)
        assert [e.stats()["megabatch"]["enabled"] for e in off] == [False, False]
        _close(off)
    finally:
        _close(pair)


def test_shard_mode_falls_back(fleet):
    """A shard-mode engine never megabatches, and its fill window is 0."""
    ref_models, port_models, _ = fleet
    from gordo_components_tpu.parallel.mesh import fleet_mesh as ref_fleet_mesh

    ours = ServingEngine(port_models, mesh=fleet_mesh(8, device="cpu"), megabatch=True,
                         fill_window_us=5000)
    ref = RefEngine(ref_models, mesh=ref_fleet_mesh(8), megabatch=True, fill_window_us=5000)
    try:
        assert not ours.megabatch and not ref.megabatch
        assert ours.stats()["megabatch"]["enabled"] is ref.stats()["megabatch"]["enabled"] is False
        assert ours.stats()["megabatch"]["fill_window_us"] == 0
        assert all(not b._mega_enabled and not b._fill_s for b in ours._buckets)
        assert ours.stats()["shard_mesh_devices"] == ref.stats()["shard_mesh_devices"] == 8
        assert ours.apply_tuning(fill_window_us=3000) == {"fill_window_us": 0}
        assert ours.apply_tuning(megabatch_residency=4) == ref.apply_tuning(
            megabatch_residency=4) == {"megabatch_residency": None}
    finally:
        ours.close()
        ref.close()


# -- residency -------------------------------------------------------------------


def test_partial_residency_promotes_after_hits_and_bounds_set(fleet, held_events):
    """Past the cap, a bucket starts with no resident machine; a machine
    earns its slot on its second cold hit, the set never exceeds the cap,
    and a fresh working set is not evicted. Each step leaves both engines
    with the same resident set."""
    pair = _engines(fleet, megabatch_residency=2, fill_window_us=0)
    ours = pair[0]
    names = ours.machines()
    try:
        bucket = ours._buckets[0]
        assert not bucket._mega_full and _residency(ours) == _residency(pair[1]) == ([], [])
        cold = _both(pair, names[0])
        assert _residency(ours) == _residency(pair[1]) == ([], [])  # one hit: not yet
        _both(pair, names[0])
        assert _residency(ours) == _residency(pair[1]) == ([0], [])  # the second promotes
        fused = _both(pair, names[0])
        assert ours.stats()["megabatch"]["requests"] == pair[1].stats()["megabatch"]["requests"] == 1
        assert _bits(fused) == _bits(cold)  # the resident stack's answer is the cold one's
        for _ in range(2):
            _both(pair, names[1])
        assert _residency(ours) == _residency(pair[1]) == ([0, 1], [])
        for _ in range(4):
            _both(pair, names[2])
            assert len(_residency(ours)[0]) <= 2
        # the freshness guard held: the third machine was not let in
        assert _residency(ours) == _residency(pair[1]) == ([0, 1], [])
        ours_moved, ref_moved = held_events()
        assert ours_moved == ref_moved
        assert ours_moved["promote"] == 2 and ours_moved["evict"] == 0
        assert ours.stats()["megabatch"] == {
            **{key: pair[1].stats()["megabatch"][key] for key in pair[1].stats()["megabatch"]},
            "fallback_cold": 0, "retry_isolated": 0}
    finally:
        _close(pair)


def test_stale_resident_is_evicted_for_a_new_machine(fleet, monkeypatch, held_events):
    """With the freshness guard off, a full resident set evicts its LRU
    machine for a new promotion, on both sides alike."""
    monkeypatch.setattr(engine_mod._Bucket, "_HOT_EVICT_AFTER", 0)
    monkeypatch.setattr(ref_engine_mod._Bucket, "_HOT_EVICT_AFTER", 0)
    pair = _engines(fleet, megabatch_residency=2, fill_window_us=0)
    names = pair[0].machines()
    try:
        for name in names[:3]:
            for _ in range(2):
                _both(pair, name)
            assert _residency(pair[0]) == _residency(pair[1])
        assert _residency(pair[0])[0] == [1, 2]
        ours_moved, ref_moved = held_events()
        assert ours_moved == ref_moved and ours_moved["evict"] == 1
    finally:
        _close(pair)


def test_fused_resident_batch_equals_the_cold_batch(fleet):
    """The same batch of resident machines through the mega path and the
    cold path: bit for bit, at k = 2 and k = 3 (a machine twice)."""
    _, port_models, _ = fleet
    engine = ServingEngine(port_models, device="cpu", megabatch_residency=3, fill_window_us=0)
    try:
        names = engine.machines()
        for name in names[:2]:
            for _ in range(2):
                engine.anomaly(name, X)
                engine.quiesce()
        bucket = engine._buckets[0]
        x_padded, m_valid = engine._prepare(bucket, X)
        for idxs in ([0, 1], [1, 0, 1]):
            runs = {}
            for path in ("mega", "cold"):
                items = [_Item(i, x_padded, m_valid) for i in idxs]
                before = bucket.mega_dispatch_count
                if path == "mega":
                    bucket._dispatch(x_padded.shape[0], items, defer=False)
                    assert bucket.mega_dispatch_count == before + 1
                else:
                    bucket._dispatch_cold(x_padded.shape[0], items, defer=False)
                    assert bucket.mega_dispatch_count == before
                assert all(it.done.wait(30) and it.error is None for it in items)
                runs[path] = [_bits(it.result) for it in items]
            assert runs["mega"] == runs["cold"]
        engine.quiesce()
    finally:
        engine.close()


def test_demoted_machine_backs_off_and_reearns_residency(fleet, held_events):
    """A demoted machine routes cold (the same answer) and needs 16 hits
    to come back (2·8); both engines demote, defer and re-admit alike."""
    pair = _engines(fleet, fill_window_us=0)
    ours, ref = pair
    names = ours.machines()
    try:
        reference = _both(pair, names[0])
        for engine in pair:
            engine._buckets[0]._mega_demote(0)
        assert _residency(ours) == _residency(ref)
        assert 0 not in _residency(ours)[0] and ours._buckets[0]._mega_demotions[0] == 1
        served = _both(pair, names[0])  # cold
        assert _bits(served) == _bits(reference)
        for _ in range(14):
            _both(pair, names[0])
        assert 0 not in _residency(ours)[0] and 0 not in _residency(ref)[0]
        _both(pair, names[0])
        assert 0 in _residency(ours)[0] and 0 in _residency(ref)[0]  # the 16th hit
        ours_moved, ref_moved = held_events()
        assert ours_moved == ref_moved
        assert ours_moved["demote"] == 1 and ours_moved["backoff_defer"] == 15
        assert ours_moved["promote"] == 1
    finally:
        _close(pair)


def test_demotion_mid_fill_window_falls_back_cold(fleet):
    """A machine demoted while a leader's fill window is open still gets
    its answer: routing runs at drain time, so the batch that holds it
    goes cold, and no fused dispatch includes it."""
    _, port_models, _ = fleet
    engine = ServingEngine(port_models, device="cpu", fill_window_us=250_000)
    names = engine.machines()
    bucket = engine._buckets[0]
    try:
        ref = {n: engine.anomaly(n, X) for n in names[:2]}
        engine.quiesce()
        mega_before = engine.stats()["megabatch"]["requests"]
        results, errors = {}, []

        def work(name):
            try:
                results[name] = engine.anomaly(name, X)
            except Exception as exc:  # pragma: no cover - reported below
                errors.append(exc)

        threads = [threading.Thread(target=work, args=(n,)) for n in names[:2]]
        with _held_bucket(bucket, expected_pending=2):
            for t in threads:
                t.start()
        deadline = time.perf_counter() + 10.0
        while not bucket._filling and time.perf_counter() < deadline:
            time.sleep(0.002)
        assert bucket._filling, "no leader opened a fill window"
        bucket._mega_demote(0)
        for t in threads:
            t.join(timeout=JOIN_S)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        for name, result in results.items():
            np.testing.assert_allclose(result.total_anomaly_score, ref[name].total_anomaly_score,
                                       rtol=1e-4, atol=1e-5)
        engine.quiesce()
        assert engine.stats()["megabatch"]["requests"] == mega_before
    finally:
        engine.close()


def _promote(pair, names):
    for name in names:
        for _ in range(2):
            _both(pair, name)


def test_mega_enqueue_failure_falls_back_cold(fleet, held_events):
    """An enqueue failure of the mega path: the caller gets the cold
    answer, the machine leaves residency (fallback_cold, demote), and it
    re-earns its slot under backoff, as in the reference."""
    pair = _engines(fleet, megabatch_residency=2, fill_window_us=0)
    ours, ref = pair
    name = ours.machines()[0]
    try:
        _promote(pair, [name])
        cold = _both(pair, name)  # resident now: this one is mega
        bucket, ref_bucket = ours._buckets[0], ref._buckets[0]
        program = bucket._program
        calls = []

        def fails_resident(idxs, xs):
            # the first program call is the resident machine's mega dispatch
            calls.append(list(idxs))
            if len(calls) == 1:
                raise RuntimeError("injected mega enqueue failure")
            return program(idxs, xs)

        def exploding(rows, k):
            raise RuntimeError("injected mega enqueue failure")

        bucket._program = fails_resident
        ref_bucket._mega_program = exploding
        try:
            served = ours.anomaly(name, X)
            _assert_parity(served, ref.anomaly(name, X))
        finally:
            del bucket._program
            del ref_bucket._mega_program
        assert _bits(served) == _bits(cold)
        assert len(calls) == 2 and bucket.mega_dispatch_count == 1  # mega, then cold
        assert _residency(ours) == _residency(ref) == ([], [])
        ours_moved, ref_moved = held_events()
        assert ours_moved == ref_moved
        assert (ours_moved["fallback_cold"], ours_moved["demote"]) == (1, 1)
        assert ours.stats()["megabatch"]["fallback_cold"] == 1
    finally:
        _close(pair)


def test_broken_fused_path_demotes_instead_of_looping(fleet, held_events):
    """A fused execution that keeps failing at fetch while every isolated
    cold retry succeeds: the first request is answered through the
    isolated retry and demotes its machine, later ones route cold."""
    pair = _engines(fleet, megabatch_residency=2, fill_window_us=0)
    ours, ref = pair
    name = ours.machines()[1]
    try:
        _promote(pair, [name])
        reference = _both(pair, name)
        mega_before = ours.stats()["megabatch"]["requests"]
        poisoned = []
        for engine in pair:
            bucket = engine._buckets[0]
            orig_fetch = bucket._fetch

            def fetch(job, orig_fetch=orig_fetch):
                if job.kind == "mega":
                    raise RuntimeError("injected fused-path failure")
                return orig_fetch(job)

            bucket._fetch = fetch
            poisoned.append(bucket)
        try:
            for _ in range(2):
                served = _both(pair, name)
                assert _bits(served) == _bits(reference)
                assert _residency(ours) == _residency(ref) == ([], [])
        finally:
            for bucket in poisoned:
                del bucket._fetch
        assert ours.stats()["megabatch"]["requests"] == mega_before
        assert ours.stats()["megabatch"]["retry_isolated"] == 1
        ours_moved, ref_moved = held_events()
        assert ours_moved == ref_moved
        assert (ours_moved["retry_isolated"], ours_moved["demote"]) == (1, 1)
    finally:
        _close(pair)


@pytest.mark.parametrize("cap", [2, 128])
def test_stats_reports_megabatch_block(fleet, cap):
    """The megabatch block counts the mega path's share alone, partial and
    full alike, as the reference's."""
    pair = _engines(fleet, megabatch_residency=cap, fill_window_us=1234)
    names = pair[0].machines()
    try:
        _promote(pair, names[:2])
        _both(pair, names[0])
        ours, theirs = (engine.stats()["megabatch"] for engine in pair)
        assert ours == {**theirs, "fallback_cold": 0, "retry_isolated": 0}
        assert ours["residency_cap"] == cap and ours["enabled"]
        assert ours["resident_machines"] == (2 if cap == 2 else N_MACHINES)
        assert ours["requests"] == (1 if cap == 2 else 5)
        assert pair[0].stats()["batched_requests"] == 5
        assert pair[0].current_tuning()["megabatch_residency"] == cap
    finally:
        _close(pair)


def test_warmup_pays_the_mega_path_in_partial_mode(fleet):
    """A partial bucket boots with no resident machine, so its warm-up
    request scores cold; ``warmup_mega`` runs one mega dispatch besides,
    and the first real promotion's mega dispatch runs no new shape."""
    _, port_models, _ = fleet
    engine = ServingEngine(port_models, device="cpu", megabatch_residency=2, fill_window_us=0)
    try:
        assert engine.warmup() == 1
        bucket = engine._buckets[0]
        assert ("mega", 64, 1) in bucket._programs and ("cold", 64, 1) in bucket._programs
        assert bucket.warm_dispatch_count == 1
        assert engine.stats()["dispatches"] == 1  # the warm-up request; no traffic
        shapes = engine.stats()["compiled_programs"]
        name = engine.machines()[1]
        for _ in range(3):
            engine.anomaly(name, X[:8])
            engine.quiesce()
        assert engine.stats()["megabatch"]["requests"] == 1
        assert engine.stats()["compiled_programs"] == shapes
        full = ServingEngine(port_models, device="cpu", fill_window_us=0)
        full.warmup()
        assert full._buckets[0].warm_dispatch_count == 0  # its warm-up request ran mega
        assert ("mega", 64, 1) in full._buckets[0]._programs
        full.close()
    finally:
        engine.close()


def test_set_mega_cap_resets_a_partial_bucket_and_answers_none_on_a_full_one(
        fleet, held_events):
    pair = _engines(fleet, megabatch_residency=2, fill_window_us=0)
    ours, ref = pair
    names = ours.machines()
    try:
        _promote(pair, names[:2])
        assert _residency(ours) == _residency(ref) == ([0, 1], [])
        assert ours.apply_tuning(megabatch_residency=4) == ref.apply_tuning(
            megabatch_residency=4) == {"megabatch_residency": 4}
        assert _residency(ours) == _residency(ref) == ([], [])  # reset at the new height
        assert ours.current_tuning()["megabatch_residency"] == 4
        assert not any(key[0] == "mega" for key in ours._buckets[0]._programs)
        assert ours.apply_tuning(megabatch_residency=4) == {"megabatch_residency": 4}
        _promote(pair, names[:3])
        assert _residency(ours) == _residency(ref) == ([0, 1, 2], [])
        scored = _both(pair, names[2])  # through the stack of height 4
        assert np.isfinite(scored.total_anomaly_score).all()
        ours_moved, ref_moved = held_events()
        assert ours_moved == ref_moved and ours_moved["residency_resize"] == 1
        full = _engines(fleet, fill_window_us=0)
        assert full[0].apply_tuning(megabatch_residency=4) == full[1].apply_tuning(
            megabatch_residency=4) == {"megabatch_residency": None}
        assert full[0].current_tuning()["megabatch_residency"] == 128
        _close(full)
    finally:
        _close(pair)


def test_pin_residency_seeds_and_the_next_cold_hit_promotes(fleet, held_events):
    """Pins do no stack work: a pinned machine that is not resident has
    its hit counter seeded, so its next cold hit promotes it, and an
    eviction skips it; the counts match the reference's."""
    pair = _engines(fleet, megabatch_residency=2, fill_window_us=0)
    ours, ref = pair
    names = ours.machines()
    try:
        _promote(pair, names[:1])
        pins = [names[0], names[3], "no-such-machine"]
        answers = [engine.pin_residency(pins) for engine in pair]
        assert answers[0] == answers[1] == {"pinned": 2, "resident": 1, "seeded": 1,
                                            "unknown": ["no-such-machine"]}
        assert _residency(ours) == _residency(ref) == ([0], [0, 3])
        _both(pair, names[3])  # one cold hit is enough now
        assert _residency(ours) == _residency(ref) == ([0, 3], [0, 3])
        _promote(pair, names[4:5])  # both slots pinned: it stays cold
        assert _residency(ours) == _residency(ref) == ([0, 3], [0, 3])
        cleared = [engine.pin_residency(()) for engine in pair]
        assert cleared[0] == cleared[1] == {"pinned": 0, "resident": 0, "seeded": 0,
                                            "unknown": []}
        assert ours.residency_pins == ()
        ours_moved, ref_moved = held_events()
        assert ours_moved == ref_moved and ours_moved["promote"] == 2
        full = _engines(fleet, fill_window_us=0)
        assert [engine.pin_residency(names[:2]) for engine in full] == [
            {"pinned": 2, "resident": 2, "seeded": 0, "unknown": []}] * 2
        _close(full)
    finally:
        _close(pair)


def _autopilot_server(root, monkeypatch, cap):
    monkeypatch.setenv("GORDO_MEGABATCH_RESIDENCY", str(cap))
    monkeypatch.setenv("GORDO_FILL_WINDOW_US", "0")
    return ModelServer(str(root), device="cpu")


def test_the_autopilot_residency_actuator_moves_a_partial_engine(fleet, tmp_path,
                                                                 monkeypatch):
    """The controller's residency actuator, unchanged: on a partial engine
    whose resident set is full and healthy it grows the cap (through
    ``apply_tuning``, which answers the new cap); on a full engine it holds
    and the seam answers None."""
    _, _, root = fleet
    for key in ("GORDO_AUTOPILOT", "GORDO_FAULTS", "GORDO_TENANTS"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("GORDO_LEDGER_DIR", str(tmp_path / "ledger"))
    monkeypatch.setenv("GORDO_TELEMETRY", "0")
    monkeypatch.setenv("GORDO_AUTOPILOT_CONFIRM", "1")
    monkeypatch.setenv("GORDO_AUTOPILOT_COOLDOWN", "0")
    monkeypatch.setenv("GORDO_AUTOPILOT_RESIDENCY_BOUNDS", "1:8")
    server = _autopilot_server(root, monkeypatch, 2)
    try:
        engine = server.engine
        for name in engine.machines()[:2]:
            for _ in range(2):
                engine.anomaly(name, X)
                engine.quiesce()
        assert engine.stats()["megabatch"]["resident_machines"] == 2
        clock = [0.0]
        pilot = build_server_autopilot(server, clock=lambda: clock[0])
        pilot.enable()
        moves = []
        for _ in range(3):  # until its first move
            clock[0] += 10.0
            moves = [d for d in pilot.tick() if d["actuator"] == "residency"]
            if moves:
                break
        assert moves and moves[0]["direction"] == "up" and moves[0]["reason"] == "residency_full"
        assert engine.current_tuning()["megabatch_residency"] == 3
        assert engine.stats()["megabatch"]["resident_machines"] == 0  # reset at the new cap
    finally:
        server.close()
    full = _autopilot_server(root, monkeypatch, 128)
    try:
        assert full.apply_tuning(megabatch_residency=8) == {"megabatch_residency": None}
        clock = [0.0]
        pilot = build_server_autopilot(full, clock=lambda: clock[0])
        pilot.enable()
        for _ in range(3):
            clock[0] += 10.0
            assert not [d for d in pilot.tick() if d["actuator"] == "residency"]
        assert full.engine.current_tuning()["megabatch_residency"] == 128
    finally:
        full.close()
