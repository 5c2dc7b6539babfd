"""The port's fleet-sharded serving mesh against the reference, on the CPU.

The reference's own cases (``tests/test_mesh_serving.py``) on the port:

- the shard plan (``parallel/shard_plan.py``): its layout equals the
  reference ``FleetShardPlan``'s exactly over 1000 seeded names, 1-8
  shards and several thresholds; ``worker_shard``, the env knobs,
  ``resolve_plan``'s gate and cache, and bounded movement on a reshard;
- the partition: a port server at shard 0 and at shard 1 of 2 beside the
  reference's, over one root of six 1-epoch dense detectors fitted by the
  reference (``mesh-000`` … ``mesh-005``, which split 3/3), agree on
  ``/healthz``'s ``mesh`` block, ``X-Gordo-Shard``, the owned and fallback
  counts of ``gordo_mesh_requests_total``, the engine's ``mesh`` block and
  the answers (atol 1e-4 in raw tag units, the zoo parity tests' bound);
  the owner's answer and another shard's fallback answer are the same
  bytes;
- the fall-backs to single-host serving (below the threshold, a shard
  outside the mesh, no shard named, no models root) and a reload that
  crosses the threshold, re-partitions, and skips a pinned machine the
  partition re-homed;
- a two-process drill over gloo: each rank holds its ``shard_bounds``
  block of a padded stacked tree, scores the requests whose machine lies
  in its block, and an ``all_reduce`` makes the output whole on every
  rank, held to the dense numpy reference (this file is also the rank
  process: ``python tests/test_torch_mesh_serving.py --rank R --world W
  --port P --out FILE``);
- the mesh router and the reconciler: ``assemble_fleet(mesh_shards=2)``
  flips between sharded and replicated placement when a ``/reload``
  crosses the threshold, as the reference's ``mesh_refresh`` does;
  ``run_fleet_server`` gives each worker its shard's argv, which an
  elastic worker's ``mesh_shard_for`` matches; ``run-fleet-server
  --mesh-shards 3 --workers 2`` is refused as the reference refuses it;
  the elastic spawn records the new worker's shard; and the reconciler's
  ``mesh`` class diverges and repairs through the router's
  ``mesh_refresh`` with a journal equal to the reference's on one clock.
"""

import argparse
import datetime
import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

FLEET = [f"mesh-{i:03d}" for i in range(6)]  # splits 3/3 over 2 shards
GROWN = [f"mesh-{i:03d}" for i in range(8)]  # splits 4/4
TAGS = [f"tag-{i}" for i in range(4)]
DEFINITION = {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
    "regressor": {"Pipeline": {"steps": ["MinMaxScaler", {"DenseAutoEncoder": {
        "kind": "feedforward_hourglass", "epochs": 1, "batch_size": 16}}]}},
    "transformer": "MinMaxScaler",
}}}}
X = (np.random.default_rng(42).normal(size=(24, len(TAGS))) * 3 + 5).astype(np.float32)
BODY = json.dumps({"X": X.tolist()}).encode()
ATOL = 1e-4  # raw tag units: the zoo parity tests' bound
FIELDS = ("model-input", "model-output", "tag-anomaly-scores", "total-anomaly-score")
_M = "/gordo/v0/project"
# process-wide knobs a server reads at construction; other files' tests set
# some of them without restoring
_KNOBS = ("GORDO_MESH_SHARDS", "GORDO_MESH_SHARD", "GORDO_MESH_MIN_SHARD_MACHINES",
          "GORDO_WORKER_ID", "GORDO_LEDGER_DIR", "GORDO_TELEMETRY_DIR", "GORDO_BOOT_EAGER",
          "GORDO_HOST_CACHE_MB", "GORDO_LAZY_BOOT", "GORDO_FAULTS")


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for name in _KNOBS:
        monkeypatch.delenv(name, raising=False)


# -- the shard plan ----------------------------------------------------------------

def _plans():
    from gordo_components_tpu.parallel import shard_plan as ref_plan

    from gordo_components_tpu_torch.parallel import shard_plan

    return shard_plan, ref_plan


NAMES = [f"m-{int(v):08x}" for v in np.random.default_rng(1234).integers(0, 2**32, 1000)]


@pytest.mark.parametrize("shards", range(1, 9))
def test_the_layout_equals_the_reference(shards):
    ours_mod, ref_mod = _plans()
    for threshold in (None, 0, 3, 10, 600, 1000, 5000):
        ours = ours_mod.FleetShardPlan(shards, min_shard_machines=threshold)
        theirs = ref_mod.FleetShardPlan(shards, min_shard_machines=threshold)
        assert ours.describe() == theirs.describe()
        assert ours.assign(NAMES) == theirs.assign(NAMES)
        assert ours.counts(NAMES) == theirs.counts(NAMES)
        for size in (0, 1, 7, 999, 1000):
            assert ours.policy(size) == theirs.policy(size)
        for fleet in (NAMES, NAMES[:5], NAMES[:37]):
            for shard in range(shards):
                assert ours.owned(fleet, shard) == theirs.owned(fleet, shard)
        for n in (0, 1, 5, 6, 7, 1000, 1001):
            assert ours.padded_height(n) == theirs.padded_height(n)
            assert ours.shard_bounds(n) == theirs.shard_bounds(n)
        with pytest.raises(ValueError):
            ours.owned(NAMES, shards)
    assert sum(ours_mod.FleetShardPlan(shards, 0).counts(NAMES)) == len(NAMES)


def test_worker_shard_names_and_env_knobs_match_the_reference(monkeypatch):
    ours, ref = _plans()
    assert [ours.worker_shard(i, 3) for i in range(7)] == [ref.worker_shard(i, 3)
                                                            for i in range(7)]
    assert [ours.worker_shard(i, 2) for i in range(5)] == [0, 1, 0, 1, 0]
    for bad in (0, -1):
        with pytest.raises(ValueError):
            ours.worker_shard(0, bad)
        with pytest.raises(ValueError):
            ours.FleetShardPlan(bad)
    assert ours.shard_name(3) == ref.shard_name(3) == "shard-3"
    assert (ours.SHARD_VNODES, ours.POLICY_SHARDED, ours.POLICY_REPLICATED) == (
        ref.SHARD_VNODES, ref.POLICY_SHARDED, ref.POLICY_REPLICATED)
    for raw in (None, "", " ", "0", "3", "-2", "x"):
        for name in ("GORDO_MESH_SHARDS", "GORDO_MESH_SHARD"):
            if raw is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, raw)
        assert ours.mesh_shards_env() == ref.mesh_shards_env()
        assert ours.mesh_shard_env() == ref.mesh_shard_env()
    monkeypatch.setenv("GORDO_MESH_MIN_SHARD_MACHINES", "9")
    assert ours.FleetShardPlan(2).min_shard_machines == ref.FleetShardPlan(2).min_shard_machines


def test_resolve_plan_env_gate_and_cache(monkeypatch):
    ours, ref = _plans()
    assert ours.mesh_shards_env() == 0
    assert ours.resolve_plan() is None and ref.resolve_plan() is None
    monkeypatch.setenv("GORDO_MESH_SHARDS", "0")
    assert ours.resolve_plan() is None
    monkeypatch.setenv("GORDO_MESH_SHARDS", "2")
    plan = ours.resolve_plan()
    assert plan is not None and plan.n_shards == 2 and plan.min_shard_machines == 4
    # the cache: the same knobs give the same immutable instance
    assert ours.resolve_plan() is plan and ours.resolve_plan(2) is plan
    assert ours.resolve_plan(2, 4) is plan and ours.resolve_plan(2, 5) is not plan
    monkeypatch.setenv("GORDO_MESH_MIN_SHARD_MACHINES", "7")
    assert ours.resolve_plan().describe() == ref.resolve_plan().describe()


def test_a_reshard_moves_a_bounded_share_as_the_reference():
    ours, ref = _plans()
    names = [f"m-{i:04d}" for i in range(300)]
    for before, after in ((2, 3), (3, 4), (4, 2)):
        moved = [n for n in names if ours.FleetShardPlan(before, 0).shard_of(n)
                 != ours.FleetShardPlan(after, 0).shard_of(n)]
        moved_ref = [n for n in names if ref.FleetShardPlan(before, 0).shard_of(n)
                     != ref.FleetShardPlan(after, 0).shard_of(n)]
        assert moved == moved_ref
        assert 0 < len(moved) < len(names) * 0.6


def test_the_router_and_the_shard_plan_import_no_torch():
    """The router's process never touches the card: it resolves the plan
    without importing torch (the parallel package loads its names lazily),
    and the package still hands out the builder's function."""
    code = (
        "import sys\n"
        "import gordo_components_tpu_torch.router\n"
        "from gordo_components_tpu_torch.parallel.shard_plan import resolve_plan\n"
        "assert resolve_plan(2).shard_of('m') in (0, 1)\n"
        "assert 'torch' not in sys.modules, 'torch imported'\n"
        "import importlib\n"
        "importlib.import_module('gordo_components_tpu_torch.parallel.build_fleet')\n"
        "from gordo_components_tpu_torch.parallel import build_fleet, fleet\n"
        "assert callable(build_fleet) and build_fleet.__name__ == 'build_fleet', build_fleet\n"
        "assert fleet.__name__.endswith('parallel.fleet')\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                            text=True, timeout=120)
    assert result.returncode == 0, result.stderr[-2000:]


# -- the partition -----------------------------------------------------------------

def _fit(seed):
    from gordo_components_tpu.serializer import pipeline_from_definition

    rows = (np.random.default_rng(seed).normal(size=(48, len(TAGS))) * 3 + 5).astype(np.float32)
    model = pipeline_from_definition(DEFINITION)
    model.fit(rows, rows)
    pred = model.predict(rows)
    model.scaler.fit(np.abs(rows[len(rows) - len(pred):] - pred))
    return model


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """``GROWN``'s detectors, fitted and dumped by the reference once."""
    from gordo_components_tpu.serializer import dump as ref_dump

    store = tmp_path_factory.mktemp("mesh-built")
    for seed, name in enumerate(GROWN):
        ref_dump(_fit(seed), str(store / name), metadata={"dataset": {"tag_list": TAGS}})
    return store


def _root(built, dest, names=FLEET):
    os.makedirs(dest, exist_ok=True)
    for name in names:
        shutil.copytree(built / name, os.path.join(dest, name))
    return str(dest)


def _ours(root, **options):
    from gordo_components_tpu_torch.server.server import ModelServer

    return ModelServer(root, device="cpu", **options)


def _theirs(root, names=FLEET, pinned=True, **options):
    from werkzeug.test import Client

    from gordo_components_tpu.server import build_app

    dirs = {name: os.path.join(root, name) for name in names} if pinned else root
    app = build_app(dirs, project="project", **options)
    return app, Client(app)


def _close(ours, app):
    ours.close()
    app.engine.close()


def _ask_ours(server, method, path, body=b"", headers=None):
    r = server.handle(method, path, {"Content-Type": "application/json", **(headers or {})}, body)
    return r.status, dict(r.headers), json.loads(r.body) if r.body else None


def _ask_theirs(client, method, path, body=b"", headers=None):
    r = client.open(path, method=method, data=body,
                    headers={"Content-Type": "application/json", **(headers or {})})
    return r.status_code, dict(r.headers), json.loads(r.get_data() or b"null")


def _mesh_counts():
    """{(shard, path): count} of gordo_mesh_requests_total in both packages."""
    from gordo_components_tpu.server import engine as ref_engine

    from gordo_components_tpu_torch.server import engine

    return dict(engine._M_MESH_REQUESTS.collect()), dict(ref_engine._M_MESH_REQUESTS.collect())


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def _same_answer(label, ours, theirs):
    for field in FIELDS:
        np.testing.assert_allclose(np.asarray(ours["data"][field], np.float64),
                                   np.asarray(theirs["data"][field], np.float64),
                                   atol=ATOL, err_msg=f"{label} {field}")


@pytest.mark.parametrize("shard", [0, 1])
def test_a_shard_partitions_counts_and_answers_as_the_reference(built, tmp_path, shard):
    plan = _plans()[0].FleetShardPlan(2)
    owned = plan.owned(FLEET, shard)
    assert len(owned) == 3  # the names split 3/3
    ours = _ours(_root(built, tmp_path / "ours"), mesh_shards=2, mesh_shard=shard)
    app, theirs = _theirs(_root(built, tmp_path / "ref"), models_root=str(tmp_path / "ref"),
                          mesh_shards=2, mesh_shard=shard)
    try:
        health = _ask_ours(ours, "GET", "/healthz")[2]
        ref_health = _ask_theirs(theirs, "GET", "/healthz")[2]
        assert health["mesh"] == ref_health["mesh"] == {
            "shard": shard, "shards": 2, "owned": 3, "remote_or_lazy": 3}
        assert health["machines"] == owned
        before = _mesh_counts()
        for name in FLEET:
            trace = f"mesh{shard}{name[-3:]}"
            status, headers, payload = _ask_ours(
                ours, "POST", f"{_M}/{name}/anomaly/prediction", BODY, {"X-Gordo-Trace-Id": trace})
            ref_status, ref_headers, ref_payload = _ask_theirs(
                theirs, "POST", f"{_M}/{name}/anomaly/prediction", BODY)
            assert status == ref_status == 200, payload
            # every answer names the shard that served it, the fallback
            # rung's too
            assert headers["X-Gordo-Shard"] == ref_headers["X-Gordo-Shard"] == str(shard)
            _same_answer(name, payload, ref_payload)
            events = [e["name"] for e in _ask_ours(ours, "GET", f"/debug/requests/{trace}")[2]
                      .get("events", [])]
            assert ("mesh_fallback" in events) == (name not in owned), events
        ours_counts, ref_counts = (_delta(a, b) for a, b in zip(_mesh_counts(), before))
        assert ours_counts == ref_counts == {(str(shard), "owned"): 3,
                                             (str(shard), "fallback"): 3}
        engine_mesh = _ask_ours(ours, "GET", "/metrics")[2]["engine"]["mesh"]
        assert engine_mesh == _ask_theirs(theirs, "GET", "/metrics")[2]["engine"]["mesh"] == {
            "shard": shard, "shards": 2, "owned_machines": 3, "remote_machines": 3}
        from gordo_components_tpu_torch.server import engine

        assert engine._M_MESH_MACHINES.collect()[(str(shard),)] == 3
    finally:
        _close(ours, app)


def test_the_owners_answer_and_a_fallback_answer_are_the_same_bytes(built, tmp_path):
    """Two workers of one mesh over one root (their shard from the worker
    id): every machine answered by its owner from the stacked tree and by
    the other shard through the spill tier, bit for bit."""
    from gordo_components_tpu_torch import wire

    root = _root(built, tmp_path / "root")
    workers = [_ours(root, mesh_shards=2, worker_id=i) for i in range(2)]
    plan = _plans()[0].FleetShardPlan(2)
    try:
        assert [w.mesh_shard for w in workers] == [0, 1]
        for name in FLEET:
            owner = plan.shard_of(name)
            answers = []
            for worker in (workers[owner], workers[1 - owner]):
                r = worker.handle("POST", f"{_M}/{name}/anomaly/prediction",
                                  {"Content-Type": "application/json",
                                   "Accept": wire.NPZ_CONTENT_TYPE}, BODY)
                assert r.status == 200
                assert r.headers["X-Gordo-Shard"] == str(worker.mesh_shard)
                assert r.headers["X-Gordo-Worker"] == str(worker.worker_id)
                answers.append(wire.payload_from_npz(r.body)["data"])
            for field in FIELDS:
                np.testing.assert_array_equal(answers[0][field], answers[1][field],
                                              err_msg=f"{name} {field}")
    finally:
        for worker in workers:
            worker.close()


FALLBACKS = ("below-threshold", "shard-outside-the-mesh", "no-shard-named", "no-models-root")


@pytest.mark.parametrize("case", FALLBACKS)
def test_the_fallbacks_to_single_host_serving_match_the_reference(built, tmp_path, monkeypatch,
                                                                  case):
    ours_root = _root(built, tmp_path / "ours")
    ref_root = _root(built, tmp_path / "ref")
    options = {"mesh_shards": 2, "mesh_shard": 1}
    if case == "below-threshold":
        monkeypatch.setenv("GORDO_MESH_MIN_SHARD_MACHINES", "100")
    elif case == "shard-outside-the-mesh":
        options["mesh_shard"] = 9
    elif case == "no-shard-named":
        options.pop("mesh_shard")
    if case == "no-models-root":
        ours = _ours({name: os.path.join(ours_root, name) for name in FLEET}, **options)
        app, theirs = _theirs(ref_root, **options)
    else:
        ours = _ours(ours_root, **options)
        app, theirs = _theirs(ref_root, models_root=ref_root, **options)
    try:
        health = _ask_ours(ours, "GET", "/healthz")[2]
        assert health["mesh"] == _ask_theirs(theirs, "GET", "/healthz")[2]["mesh"]
        assert (ours.mesh_shards, ours.mesh_shard) == (app.mesh_shards, app.mesh_shard)
        if case == "below-threshold":
            # a fleet below the threshold is replicated: every machine
            # eager on every shard, none behind the fallback rung
            assert health["mesh"] == {"shard": 1, "shards": 2, "owned": 6, "remote_or_lazy": 0}
        else:
            assert health["mesh"] is None and ours.mesh_shards == 0
        assert health["machines"] == FLEET and health["ready"]
        status, headers, _ = _ask_ours(ours, "POST", f"{_M}/{FLEET[0]}/anomaly/prediction", BODY)
        assert status == 200
        assert headers.get("X-Gordo-Shard") == (
            _ask_theirs(theirs, "POST", f"{_M}/{FLEET[0]}/anomaly/prediction", BODY)[1]
            .get("X-Gordo-Shard"))
    finally:
        _close(ours, app)


@pytest.mark.parametrize("shard", [0, 1])
def test_a_reload_repartitions_and_skips_a_pinned_machine_it_rehomes(built, tmp_path,
                                                                     monkeypatch, shard):
    """Six machines under a threshold of eight: replicated, every machine
    eager (and pinned, named at boot). Two more land and a reload crosses
    the threshold: the rescan re-partitions, and a pinned machine another
    shard now owns goes behind the spill tier instead of staying eager."""
    monkeypatch.setenv("GORDO_MESH_MIN_SHARD_MACHINES", "8")
    ours_root = _root(built, tmp_path / "ours")
    ref_root = _root(built, tmp_path / "ref")
    ours = _ours({name: os.path.join(ours_root, name) for name in FLEET},
                 models_root=ours_root, mesh_shards=2, mesh_shard=shard)
    app, theirs = _theirs(ref_root, models_root=ref_root, mesh_shards=2, mesh_shard=shard)
    plan = _plans()[0].FleetShardPlan(2, 8)
    try:
        assert _ask_ours(ours, "GET", "/healthz")[2]["mesh"] == _ask_theirs(
            theirs, "GET", "/healthz")[2]["mesh"] == {"shard": shard, "shards": 2, "owned": 6,
                                                      "remote_or_lazy": 0}
        for name in GROWN[len(FLEET):]:
            shutil.copytree(built / name, os.path.join(ours_root, name))
            shutil.copytree(built / name, os.path.join(ref_root, name))
        report = ours.reload()
        ref_report = _ask_theirs(theirs, "POST", "/reload")[2]
        assert report["total"] == ref_report["total"] == len(GROWN)
        health = _ask_ours(ours, "GET", "/healthz")[2]
        assert health["mesh"] == _ask_theirs(theirs, "GET", "/healthz")[2]["mesh"] == {
            "shard": shard, "shards": 2, "owned": 4, "remote_or_lazy": 4}
        assert health["machines"] == plan.owned(GROWN, shard) == sorted(app._state.machines)
        rehomed = sorted(set(FLEET) - set(plan.owned(GROWN, shard)))
        assert rehomed and not set(rehomed) & set(health["machines"])
        before = _mesh_counts()
        for name in rehomed:
            status, headers, payload = _ask_ours(ours, "POST", f"{_M}/{name}/anomaly/prediction",
                                                 BODY)
            ref_payload = _ask_theirs(theirs, "POST", f"{_M}/{name}/anomaly/prediction", BODY)[2]
            assert status == 200 and headers["X-Gordo-Shard"] == str(shard)
            _same_answer(name, payload, ref_payload)
        ours_counts, ref_counts = (_delta(a, b) for a, b in zip(_mesh_counts(), before))
        assert ours_counts == ref_counts == {(str(shard), "fallback"): len(rehomed)}
    finally:
        _close(ours, app)


# -- the two-process drill over gloo ------------------------------------------------

DRILL = dict(machines=6, features=3, rows=8, requests=4)


def _drill_arrays(height):
    rng = np.random.default_rng(0)
    n, f = DRILL["machines"], DRILL["features"]
    w = rng.normal(size=(height, f, f)).astype(np.float32)
    b = rng.normal(size=(height, f)).astype(np.float32)
    # padding slots repeat a live machine and are never dispatched
    w[n:], b[n:] = w[0], b[0]
    # every request targets a different machine, on both halves of the axis
    idx = (np.arange(DRILL["requests"]) * (n // 2 + 1)) % n
    xs = rng.normal(size=(DRILL["requests"], DRILL["rows"], f)).astype(np.float32)
    return w, b, idx, xs


def _drill_reference(height):
    w, b, idx, xs = _drill_arrays(height)
    return np.stack([np.linalg.norm(np.abs(xs[j] @ w[m] + b[m] - xs[j]), axis=-1)
                     for j, m in enumerate(idx)])


def _drill_rank(rank: int, world: int, port: int, out: str) -> None:
    """One rank: its ``shard_bounds`` block of the padded stacked tree, the
    requests whose machine lies in it, then an all_reduce of the output."""
    import torch.distributed as dist

    from gordo_components_tpu_torch.parallel.shard_plan import FleetShardPlan

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    try:
        plan = FleetShardPlan(world)
        height = plan.padded_height(DRILL["machines"])
        lo, hi = plan.shard_bounds(DRILL["machines"])[rank]
        w_full, b_full, idx, xs = _drill_arrays(height)
        w, b = torch.from_numpy(w_full[lo:hi]), torch.from_numpy(b_full[lo:hi])
        output = torch.zeros(DRILL["requests"], DRILL["rows"])
        scored = [j for j, m in enumerate(idx) if lo <= m < hi]
        for j in scored:
            x, m = torch.from_numpy(xs[j]), int(idx[j]) - lo
            output[j] = torch.linalg.norm((x @ w[m] + b[m] - x).abs(), dim=-1)
        dist.all_reduce(output)
        with open(out, "w") as fh:
            json.dump({"rank": rank, "bounds": [lo, hi], "height": height, "scored": scored,
                       "output": output.tolist()}, fh)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_two_ranks_over_gloo_score_their_blocks_into_one_output(tmp_path):
    world = 2
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    for attempt in range(2):  # once more on a fresh port if the rendezvous lost its port
        port = _free_port()
        outs = [str(tmp_path / f"rank{r}-{attempt}.json") for r in range(world)]
        procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--world",
                                   str(world), "--port", str(port), "--out", outs[r]],
                                  cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        logs = [p.communicate(timeout=180)[0] for p in procs]
        if all(p.returncode == 0 for p in procs):
            break
    assert [p.returncode for p in procs] == [0] * world, "\n".join(logs)
    ref_plan = _plans()[1].FleetShardPlan(world)
    height = ref_plan.padded_height(DRILL["machines"])
    reference = _drill_reference(height)
    results = [json.load(open(out)) for out in outs]
    assert [r["bounds"] for r in results] == [list(b) for b in ref_plan.shard_bounds(
        DRILL["machines"])]
    # each rank scored only its block, both blocks scored something, and
    # together every request
    assert all(r["scored"] for r in results)
    assert sorted(sum((r["scored"] for r in results), [])) == list(range(DRILL["requests"]))
    for r in results:
        assert r["height"] == height
        np.testing.assert_allclose(np.asarray(r["output"]), reference, atol=1e-5)
    assert results[0]["output"] == results[1]["output"]


# -- the mesh router, the elastic tier and the reconciler ---------------------------

def _artifact_dirs(root, names):
    for name in names:
        os.makedirs(os.path.join(root, name), exist_ok=True)
        with open(os.path.join(root, name, "definition.json"), "w") as fh:
            fh.write("{}")


def test_fleet_at_least_counts_artifact_dirs_as_the_reference(tmp_path):
    from gordo_components_tpu.router import _fleet_at_least as ref_at_least

    from gordo_components_tpu_torch.router import _fleet_at_least

    root = str(tmp_path / "root")
    _artifact_dirs(root, ["a", "b", "c", ".hidden"])
    os.makedirs(os.path.join(root, "not-an-artifact"))
    for n in (0, 1, 3, 4, 5):
        assert _fleet_at_least(root, n) == ref_at_least(root, n)
    assert _fleet_at_least(root, 3) and not _fleet_at_least(root, 4)
    # an unreadable root: the workers decide, the router never un-meshes
    assert _fleet_at_least(str(tmp_path / "missing"), 3)


@pytest.mark.usefixtures("thread_hygiene")
def test_a_mesh_router_flips_its_placement_when_a_reload_crosses_the_threshold(tmp_path):
    from gordo_components_tpu.router import assemble_fleet as ref_assemble
    from gordo_components_tpu.router import worker_specs as ref_specs
    from test_torch_router import _build_fleet, _Front, _post

    root = str(tmp_path / "root")
    _artifact_dirs(root, FLEET[:3])  # under 2 x 2 machines: replicated
    router, _ = _build_fleet(n=2, models_root=root, mesh_shards=2)
    reference = ref_assemble(ref_specs(2, 5600), lambda spec: None, models_root=root,
                             mesh_shards=2)
    front = _Front(router)
    plan = _plans()[0].FleetShardPlan(2)

    def views():
        ours = router.placement.stats()
        theirs = reference.placement.stats()
        assert ours["worker_shards"] == theirs["worker_shards"]
        assert [router.placement.candidates(n) for n in GROWN] == [
            reference.placement.candidates(n) for n in GROWN]
        return ours["worker_shards"]

    try:
        assert router.mesh_shards == 2 and views() == {}
        assert router.placement.shard_of(FLEET[0]) is None
        _artifact_dirs(root, FLEET[3:])
        assert _post(f"{front.base}/reload", b"").status_code == 200
        reference.mesh_refresh()
        assert views() == {"worker-0": 0, "worker-1": 1}
        for name in GROWN:
            shard = plan.shard_of(name)
            assert router.placement.shard_of(name) == shard
            assert router.placement.candidates(name)[0] == f"worker-{shard}"
        for name in FLEET[3:]:
            shutil.rmtree(os.path.join(root, name))
        assert _post(f"{front.base}/reload", b"").status_code == 200
        reference.mesh_refresh()
        assert views() == {}
    finally:
        front.close()
        reference.close()


class _Stop(Exception):
    pass


def _factory_of(monkeypatch, module):
    """``module.run_fleet_server``'s worker factory, caught at its
    ``assemble_fleet`` call."""
    caught = {}

    def catch(specs, factory, **kwargs):
        caught.update(specs=specs, factory=factory, kwargs=kwargs)
        raise _Stop

    monkeypatch.setattr(module, "assemble_fleet", catch)
    return caught


def _mesh_flags(argv):
    return [argv[i + 1] for i, flag in enumerate(argv) if flag in ("--mesh-shards",
                                                                 "--mesh-shard")]


def test_run_fleet_server_gives_each_worker_its_shards_argv(tmp_path, monkeypatch):
    import gordo_components_tpu.router as ref_router

    import gordo_components_tpu_torch.router as router
    from gordo_components_tpu_torch.router.placement import Placement

    flags = {}
    for name, module, extra in (("ours", router, {"device": "cpu"}), ("ref", ref_router, {})):
        caught = _factory_of(monkeypatch, module)
        with pytest.raises(_Stop):
            module.run_fleet_server(str(tmp_path), workers=3, worker_base_port=5600,
                                    mesh_shards=2, **extra)
        assert caught["kwargs"]["mesh_shards"] == 2
        # the elastic tier's next slots come from the same factory
        specs = list(caught["specs"]) + [module.WorkerSpec(f"worker-{i}", i, "127.0.0.1",
                                                           5600 + i) for i in (3, 4)]
        flags[name] = [_mesh_flags(caught["factory"](spec).argv) for spec in specs]
    assert flags["ours"] == flags["ref"] == [["2", str(i % 2)] for i in range(5)]
    # the shard an elastic worker's slot gets in the router is its argv's
    placement = Placement(["worker-0", "worker-1"])
    plan = _plans()[0].FleetShardPlan(2)
    placement.set_mesh(plan.shard_of, {"worker-0": 0, "worker-1": 1}, 2)
    assert [str(placement.mesh_shard_for(i)) for i in range(5)] == [f[1] for f in flags["ours"]]
    # without a mesh, no mesh flag
    caught = _factory_of(monkeypatch, router)
    with pytest.raises(_Stop):
        router.run_fleet_server(str(tmp_path), workers=2, device="cpu")
    assert _mesh_flags(caught["factory"](caught["specs"][0]).argv) == []


def test_run_fleet_server_refuses_more_shards_than_workers_as_the_reference(tmp_path,
                                                                            monkeypatch):
    from click.testing import CliRunner

    from gordo_components_tpu.cli.cli import gordo

    import gordo_components_tpu_torch.router as router
    from gordo_components_tpu_torch.cli.cli import main

    ref = CliRunner().invoke(gordo, ["run-fleet-server", "--models-dir", str(tmp_path),
                                     "--mesh-shards", "3", "--workers", "2"])
    assert ref.exit_code == 2 and "--mesh-shards (3)" in ref.output
    served = {}
    monkeypatch.setattr(router, "run_fleet_server",
                        lambda models_dir, **kwargs: served.update(kwargs))
    assert main(["run-fleet-server", "--models-dir", str(tmp_path), "--mesh-shards", "3",
                 "--workers", "2", "--device", "cpu"]) == 2
    assert served == {}
    # as many shards as workers serves the mesh
    assert main(["run-fleet-server", "--models-dir", str(tmp_path), "--mesh-shards", "2",
                 "--workers", "2", "--device", "cpu"]) == 0
    assert served["mesh_shards"] == 2 and served["workers"] == 2


@pytest.mark.usefixtures("thread_hygiene")
def test_an_elastic_worker_joins_its_shard_and_leaves_it(tmp_path):
    from gordo_components_tpu_torch.autopilot.elastic import ElasticWorkers
    from test_torch_router import _build_fleet

    router, _ = _build_fleet(n=2, mesh_shards=2)
    elastic = ElasticWorkers(router.supervisor, router.control, router.placement,
                             ready_timeout=10.0, drain_grace=1.0, port_allocator=_free_port)
    plan = _plans()[0].FleetShardPlan(2)
    try:
        assert elastic.scale_up() == "worker-2" and elastic.join(30)
        assert elastic.last_op()["state"] == "spawned"
        table = router.placement.stats()["worker_shards"]
        assert table == {"worker-0": 0, "worker-1": 1, "worker-2": 0}
        for name in GROWN:
            owners = {w for w, s in table.items() if s == plan.shard_of(name)}
            assert set(router.placement.candidates(name)[:len(owners)]) == owners
        assert elastic.scale_down() == "worker-2" and elastic.join(30)
        assert router.placement.stats()["worker_shards"] == {"worker-0": 0, "worker-1": 1}
    finally:
        router.control.stop()
        router.supervisor.stop_all()
        router.close()


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def _strip_at(entries):
    return [{k: v for k, v in e.items() if k != "at"} for e in entries]


@pytest.mark.usefixtures("thread_hygiene")
def test_the_reconcilers_mesh_class_repairs_through_mesh_refresh_as_the_reference(
        tmp_path, monkeypatch):
    from gordo_components_tpu.fleet import spec as ref_spec
    from gordo_components_tpu.fleet import wiring as ref_wiring
    from gordo_components_tpu.router import assemble_fleet as ref_assemble
    from test_torch_router import _build_fleet, _FakeApp, _FakeWorkerState, _ThreadWorker

    from gordo_components_tpu_torch.fleet import spec as spec_mod_ours
    from gordo_components_tpu_torch.fleet import wiring
    from gordo_components_tpu_torch.fleet.reconciler import RECONCILE_JOURNAL_FILE
    from gordo_components_tpu_torch.router import WorkerSpec

    monkeypatch.setenv("GORDO_FLEET_INTERVAL", "0")
    monkeypatch.setenv("GORDO_FLEET_COOLDOWN", "30")
    roots = {"ours": str(tmp_path / "ours"), "ref": str(tmp_path / "ref")}
    for root in roots.values():
        os.makedirs(root)
    router, _ = _build_fleet(n=2, models_root=roots["ours"], mesh_shards=2)
    ref_specs = [WorkerSpec(f"worker-{i}", i, "127.0.0.1", _free_port()) for i in range(2)]
    reference = ref_assemble(ref_specs, lambda s: _ThreadWorker(s, _FakeApp(
        _FakeWorkerState(s.name))), project="proj", models_root=roots["ref"], mesh_shards=2)
    reference.supervisor.start_all()
    runs = {}
    try:
        assert reference.supervisor.wait_ready(timeout=10) == ["worker-0", "worker-1"]
        for name, tier, spec_mod, wiring_mod in (("ours", router, spec_mod_ours, wiring),
                                                 ("ref", reference, ref_spec, ref_wiring)):
            refreshed = []
            plain = tier.mesh_refresh
            tier.mesh_refresh = lambda: refreshed.append(plain()) or None
            clock = _Clock()
            rec = wiring_mod.build_router_reconciler(tier, clock=clock)
            rec.spec_store.commit(spec_mod.FleetSpec.parse({"mesh_shards": 4}))
            ticks = []
            for advance in (0.0, 1.0, 30.0):
                clock.now += advance
                ticks.append(_strip_at(rec.tick()))
            with open(os.path.join(rec.spec_store.dir, RECONCILE_JOURNAL_FILE)) as fh:
                wal = [json.loads(line) for line in fh]
            runs[name] = (ticks, wal, len(refreshed), rec.diff_now()["divergences"])
        assert runs["ours"] == runs["ref"]
        ticks, wal, refreshed, divergences = runs["ours"]
        # declared 4 against the router's 2: the mesh class diverges, the
        # repair re-derives the layout, rests its cooldown, then repairs again
        assert [[(e["class"], e["outcome"]) for e in tick] for tick in ticks] == [
            [("mesh", "applied")], [], [("mesh", "applied")]]
        assert refreshed == 2 and [d["class"] for d in divergences] == ["mesh"]
        assert divergences[0]["actual"] == 2 and divergences[0]["desired"] == 4
    finally:
        router.control.stop()
        router.supervisor.stop_all()
        router.close()
        reference.control.stop()
        reference.supervisor.stop_all()
        reference.close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="one rank of the two-process drill")
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args()
    _drill_rank(args.rank, args.world, args.port, args.out)
