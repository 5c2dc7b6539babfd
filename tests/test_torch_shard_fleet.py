"""The port's host-sharded capacity mode against the reference's (mirrors
``tests/test_serving_engine.py:294-760``, leaving out its timing-bound
tail-latency test, ``tests/test_serving_pipeline.py:381-470`` and
``tests/test_server.py:133-147``).

The reference shards each bucket's stack over 8 virtual XLA CPU devices
(``tests/conftest.py``); the port's ``ServingEngine(mesh=fleet_mesh(8,
device="cpu"))`` splits it into 8 chunks on the CPU, so the padding, the
chunking and the gather across chunks all run. The machines are
``tests/test_torch_engine_stacked.py``'s (dense, target-subset, LSTM,
forecast and flash PatchTST, built by the reference and loaded by the
port), served at f32 and int8: scores agree with the reference's mesh
engine within atol 1e-4 on all four ``ScoreResult`` arrays, and within the
port the shard engine's answer equals the single-device engine's bit for
bit for the same batch, hot equal to cold. Hot-cache promotions, hits,
evictions, demotions and backoff deferrals equal the reference's on the
same request sequence.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu.observability.registry import REGISTRY as REF_REGISTRY  # noqa: E402
from gordo_components_tpu.parallel.mesh import fleet_mesh as ref_fleet_mesh  # noqa: E402
from gordo_components_tpu.server import engine as ref_engine_mod  # noqa: E402
from gordo_components_tpu.server.engine import ServingEngine as RefEngine  # noqa: E402

from gordo_components_tpu_torch.observability.registry import REGISTRY  # noqa: E402
from gordo_components_tpu_torch.parallel.mesh import fleet_mesh  # noqa: E402
from gordo_components_tpu_torch.server import engine as engine_mod  # noqa: E402
from gordo_components_tpu_torch.server.engine import ServingEngine, _Item  # noqa: E402

from test_torch_engine_stacked import (  # noqa: E402,F401 - fleet is a fixture
    MACHINES, TARGET_COLS, _assert_scores_match, _ported, _width, fleet)
from test_torch_megabatch import _held_bucket  # noqa: E402
from test_torch_residency import dump_and_load, events, replicas  # noqa: E402
from test_torch_server_seams import TAGS as SEAM_TAGS  # noqa: E402

# module-wide thread-hygiene gate (tests/conftest.py)
pytestmark = pytest.mark.usefixtures("thread_hygiene")

DEVICES = 8
JOIN_S = 120
HOT_EVENTS = ("promote", "evict", "demote", "backoff_defer")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh():
    return fleet_mesh(DEVICES, device="cpu")


def _bits(result):
    return tuple(np.asarray(arr).tobytes() for arr in result)


def _hot_events():
    return (events(REGISTRY, "gordo_engine_hot_cache_events_total", HOT_EVENTS),
            events(REF_REGISTRY, "gordo_engine_hot_cache_events_total", HOT_EVENTS))


def _moved(before):
    after = _hot_events()
    return tuple({k: a[k] - b[k] for k in a} for a, b in zip(after, before))


def _hot_stats(engine):
    stats = engine.stats()
    return stats["hot_machines"], stats["hot_requests"]


_ENGINES = {}


def _engines(fleet, precision):
    """The port's shard engine, its single-device engine and the
    reference's mesh engine over the whole fleet at one rung."""
    if precision not in _ENGINES:
        root, models, _ = fleet
        precisions = {name: precision for name in MACHINES}
        kwargs = dict(target_cols=TARGET_COLS, precisions=precisions)
        _ENGINES[precision] = (
            ServingEngine(_ported(root), mesh=_mesh(), **kwargs),
            ServingEngine(_ported(root), device="cpu", **kwargs),
            RefEngine(models, mesh=ref_fleet_mesh(DEVICES), **kwargs),
        )
    return _ENGINES[precision]


@pytest.fixture(scope="module", autouse=True)
def _close_engines(thread_hygiene):
    """Closes the module's engines before the thread-hygiene check runs."""
    yield
    for engines in _ENGINES.values():
        for engine in engines:
            engine.close()
    _ENGINES.clear()


# -- the mesh and the stack ------------------------------------------------------


def test_fleet_mesh_names_the_devices():
    assert fleet_mesh(device="cpu") == [torch.device("cpu")]
    assert fleet_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        fleet_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            fleet_mesh()  # the card by default, and none here
    elif torch.cuda.device_count() < 64:
        with pytest.raises(ValueError, match="only"):
            fleet_mesh(64)


def test_the_stack_is_split_and_padded_over_the_mesh(fleet):
    sharded, single, ref = _engines(fleet, "f32")
    assert sharded.stats()["shard_mesh_devices"] == ref.stats()["shard_mesh_devices"] == DEVICES
    assert single.stats()["shard_mesh_devices"] == 0
    assert sorted(sorted(b.names) for b in sharded._buckets) == sorted(
        sorted(b.names) for b in ref._buckets)
    for bucket, plain in zip(sharded._buckets, single._buckets):
        assert bucket.names == plain.names and bucket.stacked is None
        assert len(bucket.chunks) == DEVICES
        padded = DEVICES * -(-len(bucket.names) // DEVICES)
        for chunk in bucket.chunks:
            assert all(a.shape[0] == padded // DEVICES
                       for a in chunk["params"].values())
        # every chunk counts, padding included, as the reference's nbytes
        assert bucket.stacked_nbytes() * len(plain.names) == plain.stacked_nbytes() * padded
        # the padding repeats entry 0 and the chunks hold the machines in order
        rows = [torch.cat([c["sx"].scale for c in bucket.chunks])[i] for i in range(padded)]
        want = [plain.stacked["sx"].scale[i if i < len(plain.names) else 0]
                for i in range(padded)]
        assert all(torch.equal(a, b) for a, b in zip(rows, want))
    assert not sharded.megabatch and sharded.stats()["megabatch"]["enabled"] is False


# -- parity ----------------------------------------------------------------------


# the reference's PatchTST runs its Pallas kernel in interpret mode, about
# a minute a rung on the mesh: at int8 its machine is held to the port's
# single-device engine only (test_int8_patchtst_equals_the_single_device_engine)
PARITY = [(name, precision) for precision in ("f32", "int8") for name in sorted(MACHINES)
          if (name, precision) != ("patchtst", "int8")]


@pytest.mark.parametrize("name,precision", PARITY)
def test_shard_engine_matches_reference_mesh_engine(fleet, name, precision):
    """Dense, target-subset, LSTM, forecast and PatchTST machines, a
    padded machine axis (2 machines in a bucket over 8 devices, 1 in the
    others): the port's shard engine matches the reference's mesh engine
    within 1e-4, and the port's single-device engine bit for bit."""
    _, _, X = fleet
    X = X[:, : _width(name)]
    sharded, single, ref = _engines(fleet, precision)
    scored = sharded.anomaly(name, X)
    _assert_scores_match(scored, ref.anomaly(name, X))
    assert _bits(scored) == _bits(single.anomaly(name, X))
    assert np.isfinite(scored.total_anomaly_score).all()


def test_int8_patchtst_equals_the_single_device_engine(fleet):
    _, _, X = fleet
    X = X[:, : _width("patchtst")]
    sharded, single, _ = _engines(fleet, "int8")
    bucket, _ = sharded._by_name["patchtst"]
    assert bucket.precision == "int8" and len(bucket.chunks) == DEVICES
    assert _bits(sharded.anomaly("patchtst", X)) == _bits(single.anomaly("patchtst", X))


@pytest.mark.parametrize("idxs", [[1, 0], [1, 0, 1], [0, 1, 1, 0]])
def test_a_batch_across_chunks_gathers_in_batch_order(fleet, idxs):
    """A batch whose machines sit on other chunks, out of chunk order: the
    gather brings each machine to its place, and each answer equals the
    single-device engine's for the same batch bit for bit."""
    _, _, X = fleet
    sharded, single, _ = _engines(fleet, "f32")
    answers = []
    for engine in (sharded, single):
        bucket, _ = engine._by_name["dense-a"]
        assert bucket.names == ["dense-a", "dense-b"]
        items = []
        for j, i in enumerate(idxs):
            x, m_valid = engine._prepare(bucket, X[: 100 + 5 * j])
            items.append(_Item(i, x, m_valid))
        bucket._dispatch_cold(items[0].x.shape[0], items, defer=False)
        assert all(it.done.wait(30) and it.error is None for it in items)
        answers.append([_bits(it.result) for it in items])
    assert answers[0] == answers[1]
    # each machine's slices, not its neighbour's
    lone = [sharded.anomaly(name, X[: 100 + 5 * j]) for j, name in enumerate(
        ["dense-a", "dense-b"][i] for i in idxs)]
    for got, want in zip(answers[0], lone):
        for a, b in zip(got, _bits(want)):
            np.testing.assert_allclose(np.frombuffer(a, np.float32), np.frombuffer(b, np.float32),
                                       rtol=1e-5, atol=1e-5)


def test_concurrent_dispatch_over_two_buckets(fleet):
    """Two buckets hammered from 12 threads through the process-wide shard
    lock: no deadlock, every answer its machine's."""
    _, _, X = fleet
    sharded, _, _ = _engines(fleet, "f32")
    names = ("dense-a", "lstm-ae")
    expected = {name: sharded.anomaly(name, X).total_anomaly_score for name in names}
    errors, results = [], {}

    def work(name, i):
        try:
            results[(name, i)] = sharded.anomaly(name, X).total_anomaly_score
        except Exception as exc:  # pragma: no cover - reported below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(name, i)) for i in range(6) for name in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads) and not errors, errors[:3]
    assert len(results) == 12
    for (name, _), total in results.items():
        np.testing.assert_allclose(total, expected[name], rtol=1e-4, atol=1e-5)


# -- the hot cache -----------------------------------------------------------------


def _hot_pair(fleet, names=("dense-a", "dense-b"), **kwargs):
    root, models, _ = fleet
    ours = ServingEngine(_ported(root, names), mesh=_mesh(), **kwargs)
    ref = RefEngine({n: models[n] for n in names}, mesh=ref_fleet_mesh(DEVICES), **kwargs)
    return ours, ref


def _ask(pair, name, X):
    """One request through both engines, each quiesced after it; the port's
    answer, after a parity check."""
    ours, ref = pair
    scored = ours.anomaly(name, X)
    _assert_scores_match(scored, ref.anomaly(name, X))
    ours.quiesce()
    ref.quiesce()
    assert _hot_stats(ours) == _hot_stats(ref)
    return scored


def test_hot_cache_promotes_matches_and_evicts(fleet, monkeypatch):
    """A machine's second cold hit promotes a hot copy; its next request
    is hot and equals the cold answer bit for bit; at a cap of 1 the next
    promotion evicts it (the freshness guard off), and it re-earns its
    copy from zero hits. Both engines count alike at every step."""
    monkeypatch.setattr(engine_mod._Bucket, "_HOT_EVICT_AFTER", 0)
    monkeypatch.setattr(ref_engine_mod._Bucket, "_HOT_EVICT_AFTER", 0)
    _, _, X = fleet
    pair = _hot_pair(fleet, hot_cap=1)
    before = _hot_events()
    try:
        cold = _ask(pair, "dense-a", X)
        assert _hot_stats(pair[0]) == (0, 0)
        _ask(pair, "dense-a", X)
        assert _hot_stats(pair[0]) == (1, 0)
        hot = _ask(pair, "dense-a", X)
        assert _hot_stats(pair[0]) == (1, 1)
        assert _bits(hot) == _bits(cold)
        for _ in range(2):
            _ask(pair, "dense-b", X)
        assert _hot_stats(pair[0]) == (1, 1)
        _ask(pair, "dense-b", X)
        assert _hot_stats(pair[0]) == (1, 2)
        _ask(pair, "dense-a", X)
        _ask(pair, "dense-a", X)  # the second hit after its eviction
        final = _ask(pair, "dense-a", X)
        assert _hot_stats(pair[0]) == (1, 3) and _bits(final) == _bits(cold)
        ours, theirs = _moved(before)
        assert ours == theirs and (ours["promote"], ours["evict"]) == (3, 2)
        stats = pair[0].stats()
        requests = REGISTRY.counter("gordo_engine_requests_total", "", labels=("path",))
        assert stats["batched_requests"] == 9 and requests.collect()[("hot",)] >= 3
    finally:
        for engine in pair:
            engine.close()


def test_hot_cache_freshness_guard(fleet):
    """A full cache whose entry served within the freshness window keeps
    it: a machine that earned its promotion by hits stays cold."""
    _, _, X = fleet
    pair = _hot_pair(fleet, hot_cap=1)
    before = _hot_events()
    try:
        for _ in range(3):
            _ask(pair, "dense-a", X)
        for _ in range(4):
            _ask(pair, "dense-b", X)
        assert _hot_stats(pair[0]) == (1, 1)
        _ask(pair, "dense-a", X)
        assert _hot_stats(pair[0]) == (1, 2)  # still hot, never evicted
        ours, theirs = _moved(before)
        assert ours == theirs and (ours["promote"], ours["evict"]) == (1, 0)
    finally:
        for engine in pair:
            engine.close()


def test_hot_cache_stable_under_uniform_spread(tmp_path):
    """The freshness window scales with the fleet: uniform round-robin
    over 72 machines (past the 64-dispatch base window) keeps the working
    set of the first two promoted, as the reference's does."""
    ref_models = replicas(72, seed=1)
    ours = ServingEngine(dump_and_load(ref_models, tmp_path), mesh=_mesh(), hot_cap=2)
    ref = RefEngine(ref_models, mesh=ref_fleet_mesh(DEVICES), hot_cap=2)
    X = (np.random.default_rng(6).normal(size=(64, len(SEAM_TAGS))) * 2 + 4).astype(np.float32)
    names = ours.machines()
    try:
        sets = []
        for _ in range(4):
            for name in names:
                ours.anomaly(name, X)
                ref.anomaly(name, X)
            ours.quiesce()
            ref.quiesce()
            sets.append((sorted(ours._buckets[0]._hot), sorted(ref._buckets[0]._hot)))
        assert sets[1][0] == sets[1][1] and len(sets[1][0]) == 2
        assert sets[3] == sets[1]  # held, never rotated
        assert _hot_stats(ours) == _hot_stats(ref) and ours.stats()["hot_requests"] >= 4
    finally:
        ours.close()
        ref.close()


def test_failing_hot_entry_is_demoted_with_backoff(fleet):
    """A hot dispatch that fails at enqueue demotes its copy and is served
    cold (the same answer); re-promotion then takes 16 hits (2·8), the
    failed request's cold retry being the first."""
    _, _, X = fleet
    pair = _hot_pair(fleet, names=("dense-a",), hot_cap=4)
    before = _hot_events()
    ours, ref = pair
    try:
        cold = _ask(pair, "dense-a", X)
        _ask(pair, "dense-a", X)
        assert _hot_stats(ours) == (1, 0)
        bucket, ref_bucket = ours._buckets[0], ref._buckets[0]
        program = bucket._program

        def fails_hot(idxs, xs, *stack):
            if stack:
                raise RuntimeError("injected hot-dispatch failure")
            return program(idxs, xs)

        def poisoned(rows, k):
            raise RuntimeError("injected hot-dispatch failure")

        bucket._program, ref_bucket._hot_program = fails_hot, poisoned
        try:
            served = _ask(pair, "dense-a", X)  # falls back cold, never raises
        finally:
            del bucket._program
            del ref_bucket._hot_program
        assert _bits(served) == _bits(cold) and _hot_stats(ours) == (0, 0)
        for _ in range(14):
            _ask(pair, "dense-a", X)
        assert _hot_stats(ours) == (0, 0)  # still backing off
        _ask(pair, "dense-a", X)  # the 16th hit
        assert _hot_stats(ours) == (1, 0)
        again = _ask(pair, "dense-a", X)
        assert _hot_stats(ours) == (1, 1) and _bits(again) == _bits(cold)
        moved, theirs = _moved(before)
        assert moved == theirs
        assert (moved["promote"], moved["demote"], moved["backoff_defer"]) == (2, 1, 15)
    finally:
        for engine in pair:
            engine.close()


def test_hot_fetch_failure_demotes_and_retries_cold(fleet):
    """A hot dispatch that fails at the fetch: demoted, and the same
    request rescored cold on the fetch stage (``_retry_cold_sync``)."""
    _, _, X = fleet
    pair = _hot_pair(fleet, names=("dense-a",), hot_cap=2)
    ours, ref = pair
    before = _hot_events()
    try:
        cold = _ask(pair, "dense-a", X)
        _ask(pair, "dense-a", X)
        assert _hot_stats(ours) == (1, 0)
        poisoned = []
        for engine in pair:
            bucket = engine._buckets[0]
            orig = bucket._fetch

            def fetch(job, orig=orig):
                if job.kind == "hot":
                    raise RuntimeError("injected hot fetch failure")
                return orig(job)

            bucket._fetch = fetch
            poisoned.append(bucket)
        retried = []
        retry = ours._buckets[0]._retry_cold_sync
        ours._buckets[0]._retry_cold_sync = lambda items: (retried.append(len(items)),
                                                           retry(items))
        try:
            served = _ask(pair, "dense-a", X)
        finally:
            for bucket in poisoned:
                del bucket._fetch
            del ours._buckets[0]._retry_cold_sync
        assert _bits(served) == _bits(cold) and retried == [1]
        assert _hot_stats(ours) == (0, 0)
        moved, theirs = _moved(before)
        assert moved == theirs and moved["demote"] == 1
    finally:
        for engine in pair:
            engine.close()


def test_hot_and_cold_identical_at_depth_one_and_two(fleet, monkeypatch):
    """Serial and pipelined dispatch give the same bits, across the
    promotion boundary."""
    _, _, X = fleet
    root, _, _ = fleet

    def run(depth):
        monkeypatch.setenv("GORDO_DISPATCH_DEPTH", str(depth))
        engine = ServingEngine(_ported(root, ("dense-a", "dense-b")), mesh=_mesh(), hot_cap=2)
        out = [_bits(engine.anomaly("dense-a", X)), _bits(engine.anomaly("dense-a", X))]
        engine.quiesce()
        assert engine.stats()["hot_machines"] == 1
        out.append(_bits(engine.anomaly("dense-a", X)))
        assert engine.stats()["hot_requests"] == 1
        out.append(_bits(engine.anomaly("dense-b", X)))
        engine.close()
        return out

    serial, pipelined = run(1), run(2)
    assert serial == pipelined and serial[2] == serial[0]


def test_warmup_pays_the_hot_path_up_front(fleet):
    """warmup() in shard mode runs one promotion gather and one hot
    dispatch at the warmed row bucket; a real promotion and hot dispatch
    then run no new shape."""
    root, _, _ = fleet
    engine = ServingEngine(_ported(root, ("dense-a", "dense-b")), mesh=_mesh(), hot_cap=2)
    try:
        assert engine.warmup() == 1
        bucket = engine._buckets[0]
        assert ("hot", 64, 1) in bucket._programs and bucket.warm_dispatch_count == 1
        assert engine.stats()["hot_machines"] == 0  # the warm copy is dropped
        shapes = engine.stats()["compiled_programs"]
        X = np.zeros((8, 5), np.float32)
        engine.anomaly("dense-b", X)
        engine.anomaly("dense-b", X)
        engine.quiesce()
        assert engine.stats()["hot_machines"] == 1
        engine.anomaly("dense-b", X)
        assert engine.stats()["hot_requests"] == 1
        assert engine.stats()["compiled_programs"] == shapes
    finally:
        engine.close()


def test_hot_requests_queue_and_fuse_on_one_copy(fleet):
    """A pure batch of one hot machine (requests queued behind a held
    latch) is one hot dispatch; each answer equals the cold answer of the
    same batch."""
    root, _, X = fleet
    engine = ServingEngine(_ported(root, ("dense-a",)), mesh=_mesh(), hot_cap=2)
    try:
        for _ in range(2):
            engine.anomaly("dense-a", X)
        engine.quiesce()
        bucket = engine._buckets[0]
        results, errors = [], []

        def work():
            try:
                results.append(_bits(engine.anomaly("dense-a", X)))
            except Exception as exc:  # pragma: no cover - reported below
                errors.append(exc)

        threads = [threading.Thread(target=work) for _ in range(3)]
        with _held_bucket(bucket, expected_pending=3):
            for t in threads:
                t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
        assert not errors and len(results) == 3
        assert engine.stats()["hot_requests"] == 3 and bucket.max_batch_seen == 3
        x, m_valid = engine._prepare(bucket, X)
        items = [_Item(0, x, m_valid) for _ in range(3)]
        bucket._dispatch_cold(x.shape[0], items, defer=False)
        assert all(it.done.wait(30) for it in items)
        assert results == [_bits(it.result) for it in items]
        engine.quiesce()
    finally:
        engine.close()


# -- the server and the CLI ----------------------------------------------------------


SERVED = ("dense-a", "dense-b", "lstm-ae")


def _post(url, X):
    request = urllib.request.Request(url, data=json.dumps({"X": X.tolist()}).encode(),
                                     headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=60) as reply:
        return json.load(reply)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as reply:
        return json.load(reply)


def test_shard_fleet_server_matches_the_plain_server_over_http(fleet, monkeypatch):
    """``make_server(shard_fleet=True)`` against the plain server and the
    reference's ``build_app(shard_fleet=True)``, over HTTP."""
    from werkzeug.test import Client

    from gordo_components_tpu.server import build_app

    from gordo_components_tpu_torch.server.server import make_server

    monkeypatch.setenv("GORDO_TELEMETRY", "0")
    root, _, X = fleet
    dirs = {name: str(root / name) for name in SERVED}
    servers = [make_server(dirs, port=0, device="cpu", shard_fleet=flag) for flag in (True, False)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for t in threads:
        t.start()
    try:
        ref = Client(build_app(dirs, project="project", shard_fleet=True))
        sharded, plain = (f"http://127.0.0.1:{s.server_address[1]}" for s in servers)
        assert _get(sharded + "/metrics")["engine"]["shard_mesh_devices"] == 1
        assert _get(sharded + "/metrics")["engine"]["megabatch"]["enabled"] is False
        assert _get(plain + "/metrics")["engine"]["shard_mesh_devices"] == 0
        for name in SERVED:
            path = f"/gordo/v0/project/{name}/anomaly/prediction"
            a = _post(sharded + path, X)["data"]
            b = _post(plain + path, X)["data"]
            c = ref.post(path, json={"X": X.tolist()}).get_json()["data"]
            assert a == b  # the same bits, through JSON
            for field in ("model-output", "tag-anomaly-scores", "total-anomaly-score"):
                np.testing.assert_allclose(np.asarray(a[field]), np.asarray(c[field]), atol=1e-4)
    finally:
        for server, thread in zip(servers, threads):
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_run_server_shard_fleet_and_cache_warm_through_the_cli(fleet, tmp_path, capsys):
    """``cache warm --shard-fleet`` stores the set the plain warm stores;
    ``run-server --shard-fleet`` boots the shard engine, answers as the
    plain engine does, and a reload keeps shard mode."""
    from gordo_components_tpu_torch.cli import cli

    root, _, X = fleet
    models = tmp_path / "models"
    models.mkdir()
    for name in ("dense-a", "dense-b"):
        os.symlink(root / name, models / name)
    summaries = []
    for flags in ([], ["--shard-fleet"]):
        assert cli.main(["cache", "warm", "--models-dir", str(models), "--store",
                         str(tmp_path / "store"), *flags]) == 0
        summary = json.loads(capsys.readouterr().out)
        summaries.append({k: summary[k] for k in ("buckets", "machines", "skipped", "cache")})
    assert summaries[0] == summaries[1] == {"buckets": 1, "machines": 2, "skipped": {},
                                            "cache": summaries[0]["cache"]}
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": ROOT, "GORDO_TELEMETRY": "0",
           "GORDO_LEDGER_DIR": str(tmp_path / "ledger"), "JAX_PLATFORMS": "cpu"}
    env.pop("GORDO_MEGABATCH", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "gordo_components_tpu_torch.cli", "run-server", "--models-dir",
         str(models), "--shard-fleet", "--host", "127.0.0.1", "--port", str(port), "--device",
         "cpu"], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stdout.read().decode()[-3000:]
            try:
                _get(base + "/healthz")
                break
            except OSError:
                assert time.monotonic() < deadline, "run-server --shard-fleet never answered"
                time.sleep(0.2)
        engine = _get(base + "/metrics")["engine"]
        assert engine["shard_mesh_devices"] == 1 and engine["megabatch"]["enabled"] is False
        single = ServingEngine(_ported(root, ("dense-a",)), device="cpu")
        want = single.anomaly("dense-a", X)
        single.close()
        # the boot's warm-up request was dense-a's first cold hit (the
        # bucket's first machine, as in the reference): cold and promote,
        # then hot twice
        for _ in range(3):
            got = _post(base + "/gordo/v0/project/dense-a/anomaly/prediction", X)["data"]
            np.testing.assert_array_equal(np.asarray(got["total-anomaly-score"], np.float32),
                                          want.total_anomaly_score)
        engine = _get(base + "/metrics")["engine"]
        assert (engine["hot_machines"], engine["hot_requests"]) == (1, 2)
        os.symlink(root / "lstm-ae", models / "lstm-ae")
        request = urllib.request.Request(base + "/reload", data=b"", method="POST")
        with urllib.request.urlopen(request, timeout=120) as reply:
            assert json.load(reply)["added"] == ["lstm-ae"]
        engine = _get(base + "/metrics")["engine"]
        assert engine["shard_mesh_devices"] == 1 and engine["machines"] == 3
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        log = proc.stdout.read().decode()
        assert "Cross-machine megabatching off (shard mode)" in log and "Shard mode:" in log
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
