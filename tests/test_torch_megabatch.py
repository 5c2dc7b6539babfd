"""The port's stacked engine under concurrency: cross-machine megabatching
and pipelined dispatch (mirrors ``tests/test_megabatch.py`` and
``tests/test_serving_pipeline.py`` of the reference).

The machines are built by the port alone (seeded random weights, scalers
fitted on seeded data, on the CPU): what is checked here is dispatch, not
parity with the JAX package (``tests/test_torch_engine_stacked.py`` holds
that). Every dispatch runs the bucket's one program, so serial (depth 1)
and pipelined (depth 2) dispatch of the same batches agree to the bit.
Across batch SIZES a batched product may sum in another order, so fused
results are held to lone requests at rtol 1e-4 / atol 1e-5, the
reference's bound for the same check. Every threaded test joins with a
timeout of its own.
"""

import gc
import os
import threading
import time
import weakref
from contextlib import contextmanager

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu_torch.ops import flash_attention  # noqa: E402
from gordo_components_tpu_torch.serializer import pipeline_from_definition  # noqa: E402
from gordo_components_tpu_torch.server.engine import (  # noqa: E402
    ServingEngine,
    _dispatch_depth,
    _fill_window_us,
    _Item,
)

# module-wide thread-hygiene gate (tests/conftest.py): no collector thread
# may outlive the module
pytestmark = pytest.mark.usefixtures("thread_hygiene")

TAGS = 4
KINDS = {  # fleet -> (estimator, kwargs, machines, request rows)
    "dense": ("DenseAutoEncoder", dict(kind="feedforward_symmetric", dims=[4]), 6, 64),
    "lstm": ("LSTMAutoEncoder", dict(kind="lstm_symmetric", dims=[6], lookback_window=8), 3, 40),
    # 129 patches: the flash operator (its plain version here) runs
    "patchtst": ("PatchTSTAutoEncoder", dict(
        lookback_window=130, patch_length=2, stride=1, d_model=8, n_heads=2, n_layers=1,
        attention_impl="flash"), 2, 136),
}
JOIN_S = 120


def _machine(estimator, kwargs, seed):
    """A fitted anomaly detector with seeded random weights, on the CPU."""
    rng = np.random.default_rng(seed)
    model = pipeline_from_definition({"DiffBasedAnomalyDetector": {"base_estimator": {
        "TransformedTargetRegressor": {
            "regressor": {"Pipeline": {"steps": ["MinMaxScaler", {estimator: kwargs}]}},
            "transformer": "MinMaxScaler",
        }}}})
    ttr = model.base_estimator
    scaler, est = (step for _, step in ttr.regressor.steps)
    X = (rng.normal(size=(200, TAGS)) * 3 + 5).astype(np.float32)
    scaler.fit(X)
    ttr.transformer.fit(X)
    torch.manual_seed(seed)
    est.module_ = est._make_spec(TAGS, TAGS).module.eval()
    est.n_features_ = est.n_features_out_ = TAGS
    est.to("cpu")
    pred = model.predict(X)
    model.scaler.fit(np.abs(X[len(X) - len(pred):] - pred))
    return model


_FLEETS = {}


def _fleet(kind):
    if kind not in _FLEETS:
        estimator, kwargs, count, _ = KINDS[kind]
        _FLEETS[kind] = {f"{kind}-{i}": _machine(estimator, kwargs, 10 * len(_FLEETS) + i)
                         for i in range(count)}
    return _FLEETS[kind]


@pytest.fixture(scope="module")
def models():
    return _fleet("dense")


@pytest.fixture(scope="module")
def X():
    return (np.random.default_rng(5).normal(size=(64, TAGS)) * 2 + 4).astype(np.float32)


def _engine(models, depth=2, **kwargs):
    """An engine on the CPU at dispatch depth ``depth`` (read from the env
    when a bucket is built)."""
    saved = os.environ.get("GORDO_DISPATCH_DEPTH")
    os.environ["GORDO_DISPATCH_DEPTH"] = str(depth)
    try:
        return ServingEngine(models, device="cpu", **kwargs)
    finally:
        if saved is None:
            del os.environ["GORDO_DISPATCH_DEPTH"]
        else:
            os.environ["GORDO_DISPATCH_DEPTH"] = saved


def _bits(result):
    return tuple(np.asarray(arr).tobytes() for arr in result)


def _assert_close(a, b):
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-4, atol=1e-5)


def _run_threads(target, args_list):
    threads = [threading.Thread(target=target, args=args) for args in args_list]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a client thread did not finish"


@contextmanager
def _held_bucket(bucket, expected_pending):
    """Hold the bucket's leader latch so concurrent submits queue as
    followers, then release: whichever wins leadership sees them pending
    (concurrency evidence) and opens its fill window."""
    with bucket._cond:
        assert not bucket._busy
        bucket._busy = True
    try:
        yield
        deadline = time.perf_counter() + 10.0
        while time.perf_counter() < deadline:
            with bucket._cond:
                if sum(len(v) for v in bucket._pending.values()) >= expected_pending:
                    break
            time.sleep(0.002)
        else:  # pragma: no cover
            raise AssertionError("followers never queued")
    finally:
        with bucket._cond:
            bucket._busy = False
            bucket._cond.notify_all()


def _three_pending(engine, X, names):
    """Requests for ``names`` queued behind a held latch, so the leader
    dispatches them as one fused batch; returns (results, errors) by
    name."""
    bucket = engine._buckets[0]
    results, errors = {}, {}

    def work(name):
        try:
            results[name] = engine.anomaly(name, X)
        except RuntimeError as exc:
            errors[name] = str(exc)

    threads = [threading.Thread(target=work, args=(n,)) for n in names]
    with _held_bucket(bucket, expected_pending=len(names)):
        for t in threads:
            t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a waiter was never answered"
    return results, errors


# -- knobs ---------------------------------------------------------------------


def test_fill_window_env_parsing(monkeypatch):
    monkeypatch.delenv("GORDO_FILL_WINDOW_US", raising=False)
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    assert _fill_window_us() == 250
    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    assert _fill_window_us() == 1000
    monkeypatch.setenv("GORDO_FILL_WINDOW_US", "500")
    assert _fill_window_us() == 500
    monkeypatch.setenv("GORDO_FILL_WINDOW_US", "-1")
    assert _fill_window_us() == 0
    monkeypatch.setenv("GORDO_FILL_WINDOW_US", "garbage")
    assert _fill_window_us() == 1000


def test_dispatch_depth_env_parsing(monkeypatch):
    monkeypatch.delenv("GORDO_DISPATCH_DEPTH", raising=False)
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    assert _dispatch_depth() == 2
    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    assert _dispatch_depth() == 1
    monkeypatch.setattr(os, "cpu_count", lambda: None)
    assert _dispatch_depth() == 1
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    monkeypatch.setenv("GORDO_DISPATCH_DEPTH", "4")
    assert _dispatch_depth() == 4
    monkeypatch.setenv("GORDO_DISPATCH_DEPTH", "0")
    assert _dispatch_depth() == 1  # serial floor, never 0
    monkeypatch.setenv("GORDO_DISPATCH_DEPTH", "garbage")
    assert _dispatch_depth() == 2  # a bad env var must not fail a boot


def test_engine_fill_window_follows_env(monkeypatch, models):
    monkeypatch.setenv("GORDO_FILL_WINDOW_US", "777")
    engine = ServingEngine(models, device="cpu")
    assert engine.stats()["megabatch"]["fill_window_us"] == 777
    assert engine._buckets[0]._fill_s == 777e-6
    monkeypatch.setenv("GORDO_FILL_WINDOW_US", "0")
    off = ServingEngine(models, device="cpu")
    assert off.stats()["megabatch"]["fill_window_us"] == 0
    assert all(not b._fill_s for b in off._buckets)


def test_window_off_still_fuses_queued_requests(models, X):
    """With the fill window off, requests that queued while the bucket was
    busy still share the leader's dispatch, as in the reference."""
    engine = ServingEngine(models, fill_window_us=0, device="cpu")
    names = engine.machines()[:3]
    single = {n: engine.anomaly(n, X) for n in names}
    results, errors = _three_pending(engine, X, names)
    assert not errors, errors
    for name in names:
        _assert_close(results[name], single[name])
    stats = engine.stats()
    assert stats["max_dispatch_batch"] == 3
    assert stats["megabatch"]["fill_timeout_total"] == stats["megabatch"]["fill_size_total"] == 0
    engine.close()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_fused_dispatch_matches_lone_requests(kind, monkeypatch):
    """k requests for k machines in one dispatch give each machine's lone
    score; a lone request runs the scoring function unbatched, k > 1 under
    ``vmap``. A PatchTST dispatch makes ONE flash call per layer with its
    k machines folded into BH, whatever k."""
    machines = _fleet(kind)
    rows = KINDS[kind][3]
    X = (np.random.default_rng(3).normal(size=(rows, TAGS)) * 3 + 5).astype(np.float32)
    engine = ServingEngine(machines, fill_window_us=0, device="cpu")
    names = engine.machines()
    bucket, _ = engine._by_name[names[0]]
    x_padded, m_valid = engine._prepare(bucket, X)
    calls = []
    reference = flash_attention.flash_fwd_reference

    def spy(q3, k3, v3, scale):
        calls.append(tuple(q3.shape))
        return reference(q3, k3, v3, scale)

    monkeypatch.setattr(flash_attention, "flash_fwd_reference", spy)
    windows = rows - KINDS[kind][1].get("lookback_window", 1) + 1

    def dispatch(idxs):
        calls.clear()
        items = [_Item(i, x_padded, m_valid) for i in idxs]
        out = bucket._host(bucket._enqueue(idxs, bucket._batch_inputs(items)))
        if kind == "patchtst":  # one call per dispatch (one layer)
            assert calls == [(len(idxs) * windows * TAGS * 2, 129, 4)]
        return [[a[j] for a in out] for j in range(len(idxs))]

    lone = {idx: dispatch([idx])[0] for idx in (0, 1)}
    for k in (2, 4):
        idxs = [i % 2 for i in range(k)]
        for idx, scored in zip(idxs, dispatch(idxs)):
            _assert_close(scored, lone[idx])
    engine.close()


def test_concurrent_spread_traffic_fuses_and_matches_single_requests(models, X):
    """12 threads spread over 6 machines: every answer matches the same
    request scored alone, and fused dispatches carry more than one request
    on average."""
    engine = _engine(models, fill_window_us=3000)
    names = engine.machines()
    single = {n: engine.anomaly(n, X) for n in names}
    engine.quiesce()
    before = engine.stats()["megabatch"]
    errors = []
    barrier = threading.Barrier(12)

    def work(t):
        try:
            barrier.wait(timeout=30)
            for i in range(10):
                name = names[(t + i) % len(names)]
                _assert_close(engine.anomaly(name, X), single[name])
        except Exception as exc:  # pragma: no cover - reported below
            errors.append(exc)

    _run_threads(work, [(t,) for t in range(12)])
    assert not errors, errors[:3]
    engine.quiesce()
    stats = engine.stats()["megabatch"]
    requests = stats["requests"] - before["requests"]
    dispatches = stats["dispatches"] - before["dispatches"]
    assert requests == 120
    assert requests / dispatches > 1, stats
    assert stats["fill_timeout_total"] + stats["fill_size_total"] > 0
    assert stats["fallback_cold"] == stats["retry_isolated"] == 0
    assert engine.stats()["max_dispatch_batch"] > 1
    engine.close()


# -- fill window -------------------------------------------------------------


def test_idle_request_bypasses_fill_window(models, X):
    engine = ServingEngine(models, fill_window_us=2_000_000, device="cpu")
    name = engine.machines()[0]
    engine.anomaly(name, X)
    started = time.perf_counter()
    engine.anomaly(name, X)
    assert time.perf_counter() - started < 1.0, "an idle request waited out the window"
    stats = engine.stats()["megabatch"]
    assert stats["fill_timeout_total"] == stats["fill_size_total"] == 0
    engine.close()


def test_full_pending_batch_size_triggers_before_timeout(models, X):
    engine = ServingEngine(models, fill_window_us=10_000_000, max_batch=3, device="cpu")
    names = engine.machines()
    for n in names:
        engine.anomaly(n, X)
    engine.quiesce()
    bucket = engine._buckets[0]
    errors = []

    def work(i):
        try:
            engine.anomaly(names[i % len(names)], X)
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    started = time.perf_counter()
    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    with _held_bucket(bucket, expected_pending=4):
        for t in threads:
            t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert time.perf_counter() - started < 8.0, "the size trigger did not pre-empt the window"
    assert engine.stats()["megabatch"]["fill_size_total"] >= 1
    engine.close()


def test_a_closing_fill_window_observes_its_occupancy(models, X):
    """``gordo_engine_fill_window_occupancy``: each fill window that closes
    observes its largest pending batch over ``max_batch``; a size trigger
    observes 1.0, as the reference's engine does."""
    from gordo_components_tpu_torch.observability.registry import REGISTRY

    occupancy = {m.name: m for m in REGISTRY.metrics()}["gordo_engine_fill_window_occupancy"]

    def observed():
        data = occupancy.collect().get((), {"count": 0, "sum": 0.0})
        return data["count"], data["sum"]

    engine = ServingEngine(models, fill_window_us=10_000_000, max_batch=3, device="cpu")
    names = engine.machines()
    for n in names:
        engine.anomaly(n, X)
    engine.quiesce()
    before = observed()
    threads = [threading.Thread(target=engine.anomaly, args=(names[i % len(names)], X))
               for i in range(4)]
    with _held_bucket(engine._buckets[0], expected_pending=4):
        for t in threads:
            t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)
    windows = engine.stats()["megabatch"]["fill_size_total"]
    windows += engine.stats()["megabatch"]["fill_timeout_total"]
    count, total = observed()
    assert windows >= 1 and count - before[0] == windows
    assert total - before[1] >= 1.0  # the size-triggered window was full
    engine.close()


# -- repairs -----------------------------------------------------------------


def test_fused_enqueue_failure_rescores_one_request_per_dispatch(models, X):
    engine = ServingEngine(models, fill_window_us=0, device="cpu")
    names = engine.machines()[:3]
    ref = {n: engine.anomaly(n, X) for n in names}
    engine.quiesce()
    bucket = engine._buckets[0]
    program = bucket._program

    def fails_fused(idxs, xs):
        if len(idxs) > 1:
            raise RuntimeError("injected fused enqueue failure")
        return program(idxs, xs)

    bucket._program = fails_fused
    try:
        results, errors = _three_pending(engine, X, names)
    finally:
        del bucket._program
    assert not errors, errors
    for name in names:
        assert _bits(results[name]) == _bits(ref[name])  # lone dispatches both
    mega = engine.stats()["megabatch"]
    assert mega["fallback_cold"] == 1 and mega["retry_isolated"] == 0
    engine.close()


def test_one_bad_machine_in_fused_batch_fails_only_its_own_waiters(models, X):
    engine = ServingEngine(models, fill_window_us=0, device="cpu")
    names = engine.machines()[:3]
    bucket = engine._buckets[0]
    bad_idx = engine._by_name[names[0]][1]
    ref = {n: engine.anomaly(n, X) for n in names}
    engine.quiesce()
    orig_fetch, program = bucket._fetch, bucket._program

    def poisoned_fetch(job):
        if len(job.items) > 1:
            raise RuntimeError("injected fused execution failure")
        return orig_fetch(job)

    def poisoned_program(idxs, xs):
        if len(idxs) == 1 and idxs[0] == bad_idx:
            raise RuntimeError("injected bad-machine failure")
        return program(idxs, xs)

    bucket._fetch, bucket._program = poisoned_fetch, poisoned_program
    try:
        results, errors = _three_pending(engine, X, names)
    finally:
        del bucket._fetch
        del bucket._program
    assert set(errors) == {names[0]} and "bad-machine" in errors[names[0]], errors
    for name in names[1:]:
        _assert_close(results[name], ref[name])
    assert engine.stats()["megabatch"]["retry_isolated"] == 1
    assert _bits(engine.anomaly(names[0], X)) == _bits(ref[names[0]])  # served again
    engine.close()


@pytest.mark.parametrize("stage", ["enqueue", "fetch"])
def test_sticky_fault_fails_each_waiter_once(models, X, stage):
    """A fault that every later call also hits (a sticky device error):
    the fused batch is rescored one request at a time, each waiter gets
    the error once, and nothing loops."""
    engine = ServingEngine(models, fill_window_us=0, device="cpu")
    names = engine.machines()[:3]
    ref = {n: engine.anomaly(n, X) for n in names}
    engine.quiesce()
    bucket = engine._buckets[0]
    seam = "_program" if stage == "enqueue" else "_host"
    calls = []

    def sticky(*args):
        calls.append(args)
        raise RuntimeError("injected sticky fault")

    setattr(bucket, seam, sticky)
    try:
        results, errors = _three_pending(engine, X, names)
    finally:
        delattr(bucket, seam)
    assert not results and set(errors) == set(names)
    assert all("sticky" in message for message in errors.values())
    assert len(calls) == 4  # the fused batch, then each request once
    mega = engine.stats()["megabatch"]
    assert (mega["fallback_cold"], mega["retry_isolated"]) == (
        (1, 0) if stage == "enqueue" else (0, 1))
    engine.quiesce()
    assert _bits(engine.anomaly(names[1], X)) == _bits(ref[names[1]])
    engine.close()


@pytest.mark.parametrize("stage", ["enqueue", "fetch"])
def test_cold_batch_failure_fails_only_the_bad_machines_waiters(models, X, stage):
    """Megabatch off, so every dispatch is cold: a cold batch of three
    machines that fails (at enqueue on its bad machine, or at fetch) is
    rescored one request per cold dispatch, and only the bad machine's
    waiter gets the error."""
    engine = ServingEngine(models, fill_window_us=0, device="cpu", megabatch=False)
    names = engine.machines()[:3]
    bucket = engine._buckets[0]
    bad_idx = engine._by_name[names[0]][1]
    ref = {n: engine.anomaly(n, X) for n in names}
    engine.quiesce()
    orig_fetch, program = bucket._fetch, bucket._program

    def poisoned_program(idxs, xs):
        # at enqueue the bad machine fails any dispatch it is in; at fetch
        # its batch fails and its own isolated retry fails too
        if bad_idx in idxs and (stage == "enqueue" or len(idxs) == 1):
            raise RuntimeError("injected bad-machine failure")
        return program(idxs, xs)

    def poisoned_fetch(job):
        if len(job.items) > 1:
            raise RuntimeError("injected batch execution failure")
        return orig_fetch(job)

    bucket._program = poisoned_program
    if stage == "fetch":
        bucket._fetch = poisoned_fetch
    try:
        results, errors = _three_pending(engine, X, names)
    finally:
        del bucket._program
        if stage == "fetch":
            del bucket._fetch
    assert set(errors) == {names[0]} and "bad-machine" in errors[names[0]], errors
    for name in names[1:]:
        assert _bits(results[name]) == _bits(ref[name])  # lone cold dispatches both
    mega = engine.stats()["megabatch"]
    assert mega["dispatches"] == 0 and (mega["fallback_cold"], mega["retry_isolated"]) == (
        (1, 0) if stage == "enqueue" else (0, 1))
    engine.quiesce()
    assert _bits(engine.anomaly(names[0], X)) == _bits(ref[names[0]])  # served again
    engine.close()


def test_demoted_machine_in_a_mixed_batch_fails_only_its_own_waiters(models, X):
    """A fully resident engine whose machine was demoted (a mega failure):
    a batch holding it routes cold, and while it keeps failing, the healthy
    machines batched with it are rescored one per cold dispatch and
    answered."""
    engine = ServingEngine(models, fill_window_us=0, device="cpu")
    names = engine.machines()[:3]
    bucket = engine._buckets[0]
    bad_idx = engine._by_name[names[0]][1]
    ref = {n: engine.anomaly(n, X) for n in names}
    engine.quiesce()
    bucket._mega_demote(bad_idx)
    mega_before = engine.stats()["megabatch"]["dispatches"]
    program = bucket._program

    def poisoned_program(idxs, xs):
        if bad_idx in idxs:
            raise RuntimeError("injected bad-machine failure")
        return program(idxs, xs)

    bucket._program = poisoned_program
    try:
        results, errors = _three_pending(engine, X, names)
    finally:
        del bucket._program
    assert set(errors) == {names[0]} and "bad-machine" in errors[names[0]], errors
    for name in names[1:]:
        assert _bits(results[name]) == _bits(ref[name])
    engine.quiesce()
    mega = engine.stats()["megabatch"]
    assert mega["dispatches"] == mega_before  # the mixed batch went cold
    assert (mega["fallback_cold"], mega["retry_isolated"]) == (1, 0)
    assert bad_idx not in bucket._mega_slots
    engine.close()


def test_programs_racing_on_one_template_keep_every_answer_right(models, X):
    """Stress: the leader and the collector (an isolated retry) may run
    the program of one bucket at once, and ``functional_call`` swaps the
    shared template's parameters for a call's duration. 16 threads (more
    than the cores), a thread switch every 10 µs, each running lone and
    fused dispatches for its own machine: every result must be its
    machine's."""
    import sys

    engine = _engine(models, fill_window_us=0)
    names = engine.machines()
    bucket = engine._buckets[0]
    single = {engine._by_name[n][1]: engine.anomaly(n, X) for n in names}
    x_padded, m_valid = engine._prepare(bucket, X)
    errors = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def work(t):
        try:
            idx = t % len(names)
            for i in range(20):
                k = 1 + i % 2
                xs = bucket._batch_inputs([_Item(idx, x_padded, m_valid)] * k)
                out = bucket._host(bucket._enqueue([idx] * k, xs))
                for j in range(k):
                    _assert_close([a[j][:m_valid] for a in out], single[idx])
        except Exception as exc:  # pragma: no cover - reported below
            errors.append(exc)

    try:
        _run_threads(work, [(t,) for t in range(16)])
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors[:3]
    engine.close()


# -- pipelined dispatch --------------------------------------------------------


@pytest.fixture(scope="module")
def requests_x():
    """Requests at distinct padded row buckets (64/128/256/512), so every
    dispatch is a singleton and both depths run the same programs."""
    X = (np.random.default_rng(7).normal(size=(400, TAGS)) * 3 + 5).astype(np.float32)
    return {60: X[:60], 100: X[:100], 200: X[:200], 400: X}


def test_depth_one_equals_depth_two(models, requests_x):
    pair = {n: models[n] for n in sorted(models)[:2]}
    serial, pipelined = _engine(pair, depth=1), _engine(pair, depth=2)
    assert serial.stats()["dispatch_depth"] == 1 and pipelined.stats()["dispatch_depth"] == 2
    reference = {(n, rows): _bits(serial.anomaly(n, X))
                 for rows, X in requests_x.items() for n in pair}
    results, errors = {}, []
    barrier = threading.Barrier(len(requests_x))

    def work(rows, X):
        try:
            barrier.wait(timeout=30)
            for i, name in enumerate(sorted(pair) * 3):
                results[(name, rows, i)] = _bits(pipelined.anomaly(name, X))
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    _run_threads(work, list(requests_x.items()))
    assert not errors and len(results) == len(requests_x) * 6
    for (name, rows, _), bits in results.items():
        assert bits == reference[(name, rows)], (name, rows)
    assert pipelined.stats()["max_dispatch_batch"] == 1
    serial.close()
    pipelined.close()


def test_chunked_backfill_identical_at_depth_one_and_two(models):
    long_X = (np.random.default_rng(9).normal(size=(300, TAGS)) * 3 + 5).astype(np.float32)
    kwargs = dict(max_rows_dispatch=64, min_rows_bucket=16)
    serial, pipelined = _engine(models, 1, **kwargs), _engine(models, 2, **kwargs)
    for name in sorted(models)[:2]:
        a, b = pipelined.anomaly(name, long_X), serial.anomaly(name, long_X)
        assert len(a.total_anomaly_score) == 300
        assert _bits(a) == _bits(b)
    assert pipelined.stats()["dispatches"] >= 4
    serial.close()
    pipelined.close()


def test_mid_pipeline_error_surfaces_on_exactly_its_own_waiters(models, requests_x):
    """A lone cold dispatch's fetch failure errors exactly its own waiters.
    Megabatch off, as in the reference's test: this pins the cold
    pipeline's error fan-out (the mega path repairs a fetch failure by the
    isolated cold retry instead, tested above)."""
    name = sorted(models)[0]
    engine = _engine({name: models[name]}, depth=4, megabatch=False)
    reference = {rows: _bits(engine.anomaly(name, X)) for rows, X in requests_x.items()}
    bucket, _ = engine._by_name[name]
    engine.quiesce()
    orig_fetch = bucket._fetch

    def poisoned(job):
        if job.rows == 128:  # the padded bucket of the 100-row request
            raise RuntimeError("injected mid-pipeline fetch failure")
        return orig_fetch(job)

    bucket._fetch = poisoned
    outcomes = {}
    barrier = threading.Barrier(len(requests_x))

    def work(rows, X):
        try:
            barrier.wait(timeout=30)
            outcomes[rows] = ("ok", _bits(engine.anomaly(name, X)))
        except RuntimeError as exc:
            outcomes[rows] = ("error", str(exc))

    try:
        _run_threads(work, list(requests_x.items()))
    finally:
        del bucket._fetch
    assert len(outcomes) == len(requests_x)
    for rows, (kind, value) in outcomes.items():
        if rows == 100:
            assert kind == "error" and "injected mid-pipeline" in value
        else:
            assert kind == "ok" and value == reference[rows], rows
    assert _bits(engine.anomaly(name, requests_x[100])) == reference[100]
    engine.close()


def test_enqueue_time_error_surfaces_on_waiters(models):
    name = sorted(models)[0]
    engine = _engine({name: models[name]})
    X = np.zeros((8, TAGS), np.float32)
    engine.anomaly(name, X)
    bucket, _ = engine._by_name[name]

    def exploding(idxs, xs):
        raise RuntimeError("injected enqueue failure")

    bucket._program = exploding
    try:
        with pytest.raises(RuntimeError, match="injected enqueue failure"):
            engine.anomaly(name, X)
    finally:
        del bucket._program
    assert np.isfinite(engine.anomaly(name, X).total_anomaly_score).all()  # latch released
    engine.close()


def test_post_fetch_bookkeeping_error_surfaces_not_hangs(models):
    name = sorted(models)[0]
    engine = _engine({name: models[name]})
    X = np.zeros((8, TAGS), np.float32)
    first = engine.anomaly(name, X)
    bucket, _ = engine._by_name[name]

    def boom(items, *arrays):
        raise IndexError("injected post-fetch failure")

    bucket._fill_results = boom
    try:
        with pytest.raises(IndexError, match="injected post-fetch"):
            engine.anomaly(name, X)
    finally:
        del bucket._fill_results
    assert _bits(engine.anomaly(name, X)) == _bits(first)
    engine.close()


def test_close_and_reuse(models, requests_x):
    name = sorted(models)[0]
    engine = _engine({name: models[name]})
    X = np.zeros((8, TAGS), np.float32)
    first = engine.anomaly(name, X)
    bucket, _ = engine._by_name[name]
    assert bucket._collector is None  # a lone request fetches inline

    def concurrent_round():
        """The four requests (four row buckets) queued behind a held latch:
        one leader drains them as four dispatches, and every one but the
        last hands its fetch to the collector, however the threads are
        scheduled."""
        errors = []

        def work(X):
            try:
                engine.anomaly(name, X)
            except Exception as exc:  # pragma: no cover
                errors.append(exc)

        threads = [threading.Thread(target=work, args=(X,)) for X in requests_x.values()]
        with _held_bucket(bucket, expected_pending=len(threads)):
            for t in threads:
                t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
        assert not any(t.is_alive() for t in threads), "a client thread did not finish"
        assert not errors

    concurrent_round()  # concurrency engages the pipeline
    collector = bucket._collector
    assert collector is not None and collector.is_alive()
    engine.close()
    assert not collector.is_alive()
    assert _bits(engine.anomaly(name, X)) == _bits(first)  # a closed engine serves
    concurrent_round()
    assert bucket._collector is not None and bucket._collector.is_alive()
    engine.close()


def test_failed_dispatch_does_not_pin_dropped_engine(models):
    """A failed fetch's traceback references the bucket; the collector must
    not keep its last job alive, or a dropped engine is never collected.
    Megabatch off, as in the reference's test: a cold fetch failure fails
    its waiter (the mega path would rescore it)."""
    name = sorted(models)[0]
    engine = _engine({name: models[name]}, megabatch=False)
    X = np.zeros((100, TAGS), np.float32)
    engine.anomaly(name, X)
    bucket, idx = engine._by_name[name]

    def poisoned(job):
        raise RuntimeError("injected fetch failure")

    bucket._fetch = poisoned
    try:
        x_padded, m_valid = engine._prepare(bucket, X)
        item = _Item(idx, x_padded, m_valid)
        bucket._dispatch(x_padded.shape[0], [item], defer=True)
        assert item.done.wait(timeout=30) and isinstance(item.error, RuntimeError)
    finally:
        del bucket._fetch
    engine_ref, bucket_ref = weakref.ref(engine), weakref.ref(bucket)
    del engine, bucket, item
    deadline = time.monotonic() + 10.0
    while (engine_ref() is not None or bucket_ref() is not None) and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.05)
    assert engine_ref() is None and bucket_ref() is None


# -- tuning, stats, warmup ---------------------------------------------------


def test_apply_tuning_retargets_a_running_engine(models, X):
    engine = _engine(models, fill_window_us=100)
    name = engine.machines()[0]
    before = _bits(engine.anomaly(name, X))
    applied = engine.apply_tuning(dispatch_depth=3, fill_window_us=5000)
    assert applied == {"dispatch_depth": 3, "fill_window_us": 5000}
    # every machine is resident: the residency cap is the reference's
    # default, and a residency value is not applicable (None)
    assert engine.current_tuning() == {"dispatch_depth": 3, "fill_window_us": 5000,
                                       "megabatch_residency": 128}
    assert engine.apply_tuning(megabatch_residency=4) == {"megabatch_residency": None}
    assert engine.current_tuning()["megabatch_residency"] == 128
    assert engine._buckets[0]._fill_s == 0.005
    assert engine._buckets[0]._inflight_slots._depth == 3
    assert _bits(engine.anomaly(name, X)) == before
    assert engine.apply_tuning(fill_window_us=-5) == {"fill_window_us": 0}
    assert engine._buckets[0]._fill_s == 0
    engine.close()


def test_stats_reports_the_engine_and_megabatch_blocks(models, X):
    engine = ServingEngine(models, fill_window_us=1234, device="cpu")
    stats = engine.stats()
    assert stats["machines"] == len(models) and stats["buckets"] == 1
    assert stats["host_path_machines"] == {} and stats["dispatches"] == 0
    assert stats["precision"] == {"machines": {"f32": len(models)}, "requests": {"f32": 0}}
    mega = stats["megabatch"]
    assert mega["fill_window_us"] == 1234
    assert mega["fusion_ratio"] is None
    assert mega["fallback_cold"] == mega["retry_isolated"] == 0
    engine.anomaly(engine.machines()[0], X)
    engine.quiesce()
    stats = engine.stats()
    assert stats["dispatches"] == stats["batched_requests"] == 1
    assert stats["megabatch"]["dispatches"] == stats["megabatch"]["requests"] == 1
    assert stats["megabatch"]["fusion_ratio"] == 1.0
    assert stats["precision"]["requests"] == {"f32": 1}
    engine.close()


def test_warmup_scores_one_request_per_bucket(models):
    engine = ServingEngine(models, fill_window_us=0, device="cpu")
    assert engine.warmup() == 1
    assert engine.stats()["dispatches"] == 1
    engine.close()
