"""The port's host-RAM spill tier against its own stacked engine and the
reference's spill tier, on the CPU.

Anomaly machines are fitted by the JAX package (a dense pair of one
architecture, a dense machine at each of the bf16 and int8 rungs, and an
LSTM autoencoder at f32 and bf16) and committed as generations, the int8
one with its ``quant_int8.npz``. Each engine registers them lazily through
its own server's store-path loader (``ModelServer._lazy_loader``: manifest
verified, artifact loaded, the machine parked in the bundle). A spilled
answer must equal the same machine's lone answer from the port's stacked
engine by ``np.array_equal`` (one scoring closure, run unbatched on the
machine's own tree), and the reference engine's spilled answer within atol
1e-4 in raw tag units (values around 5 ± 3), the bound of
``tests/test_torch_zoo_serving.py``. Then: a cap of 0 pays the store path
every time, prefetch hints are advisory, a chunked spill request equals the
unchunked one, a lazy machine the engine cannot lift raises
``SpillNotLiftable`` with its estimators on the engine's device,
``stats()`` and ``cost_ledger()`` carry the reference's keys, and more
request threads than cores, racing loads against evictions in a cache that
holds one bundle, each get their own machine's lone answer to the bit.
"""

import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu.server.engine import ServingEngine as RefEngine  # noqa: E402
from gordo_components_tpu.server.server import ModelServer as RefServer  # noqa: E402

from gordo_components_tpu_torch import wire  # noqa: E402
from gordo_components_tpu_torch.server.engine import ServingEngine, SpillNotLiftable  # noqa: E402
from gordo_components_tpu_torch.server.host_cache import HostTierCache  # noqa: E402
from gordo_components_tpu_torch.server.server import ModelServer, _Machine  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_lazy_boot import DENSE, LSTM, LOOKBACK, X, _commit, _config, _fit  # noqa: E402

MACHINES = {  # name -> (estimator, kwargs, precision, data seed)
    "dense-a": (*DENSE, "f32", 1),
    "dense-b": (*DENSE, "f32", 2),
    "dense-bf16": (*DENSE, "bf16", 3),
    "dense-int8": (*DENSE, "int8", 4),
    "lstm-ae": (*LSTM, "f32", 5),
    "lstm-bf16": (*LSTM, "bf16", 6),
}
@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """{name: generation root}: MACHINES, and a FeatureUnion machine the
    engine cannot lift."""
    root = tmp_path_factory.mktemp("spill")
    paths = {name: _commit(root, name, _fit(_config(estimator, kwargs), seed), precision)
             for name, (estimator, kwargs, precision, seed) in MACHINES.items()}
    union = {"FeatureUnion": {"transformer_list": ["MinMaxScaler", "StandardScaler"]}}
    paths["union"] = _commit(root, "union", _fit(_config(*DENSE, steps=[union]), 7), "f32")
    return paths


def _lazy(paths, names, loader=ModelServer._lazy_loader):
    return {name: loader(name, paths[name]) for name in names}


def _port_lazy(fleet, names=tuple(MACHINES), cap_mb=64):
    return ServingEngine({}, lazy=_lazy(fleet, names), host_cache_mb=cap_mb, device="cpu")


def _port_eager(fleet, names=tuple(MACHINES)):
    machines = {name: _Machine(name, fleet[name]) for name in names}
    return ServingEngine(
        {name: m.model for name, m in machines.items()},
        precisions={name: m.precision for name, m in machines.items()},
        quantized={name: m.quantized for name, m in machines.items() if m.quantized is not None},
        device="cpu",
    )


def _bits(result):
    return [np.asarray(arr) for arr in result]


def _assert_equal(got, want):
    for field, a, b in zip(wire.SCORE_FIELDS, _bits(got), _bits(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b), field


_REF = {}


def _reference(fleet, name):
    """The reference engine's spilled answer, once per machine."""
    if name not in _REF:
        engine = RefEngine({}, lazy=_lazy(fleet, [name], RefServer._lazy_loader),
                           megabatch=False, host_cache_mb=64)
        _REF[name] = engine.anomaly(name, X)
        engine.quiesce()
    return _REF[name]


@pytest.mark.parametrize("name", sorted(MACHINES))
def test_spilled_answer_equals_the_lone_eager_answer_and_the_reference(fleet, name):
    lazy, eager = _port_lazy(fleet, [name]), _port_eager(fleet, [name])
    try:
        assert lazy.has_lazy(name) and lazy.can_score(name) and lazy.machines() == [name]
        want = eager.anomaly(name, X)
        cold = lazy.anomaly(name, X)  # the store path
        hit = lazy.anomaly(name, X)  # the host cache
        _assert_equal(cold, want)
        _assert_equal(hit, want)
        stats = lazy.host_cache.stats()
        assert (stats["loads"], stats["misses"], stats["hits"]) == (1, 1, 1)
        for field, a, b in zip(wire.SCORE_FIELDS, cold, _reference(fleet, name)):
            assert a.shape == b.shape, field
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=field)
        rung = MACHINES[name][2]
        assert lazy.cost_ledger()["rungs"][rung]["requests"] == 2
        assert lazy.cost_ledger()["rungs"][rung]["device_bytes"] == 0
    finally:
        lazy.close()
        eager.close()


def test_one_scorer_per_architecture_and_the_reference_keys(fleet):
    lazy = _port_lazy(fleet, ["dense-a", "dense-b", "lstm-ae"])
    ref = RefEngine({}, lazy=_lazy(fleet, ["dense-a"], RefServer._lazy_loader),
                    megabatch=False, host_cache_mb=64)
    try:
        for name in ("dense-a", "dense-b", "lstm-ae"):
            lazy.anomaly(name, X)
        ref.anomaly("dense-a", X)
        ours, theirs = lazy.stats(), ref.stats()
        assert set(theirs["spill"]) <= set(ours["spill"])
        assert set(ours["spill"]["host_cache"]) == set(theirs["spill"]["host_cache"])
        assert ours["spill"]["scorers"] == 2 and ours["spill"]["lazy_machines"] == 3
        costs, ref_costs = lazy.cost_ledger(), ref.cost_ledger()
        assert set(costs) == set(ref_costs)
        for block in ("host_cache", "spill"):
            assert set(costs[block]) == set(ref_costs[block]), block
        assert costs["spill"] == {"lazy_machines": 3, "scorers": 2, "requests_total": 3}
        assert costs["host_cache"]["loads"] == 3 and costs["host_cache"]["bytes"] > 0
    finally:
        lazy.close()
        ref.quiesce()


def test_cap_zero_always_pays_the_store_path(fleet):
    lazy, eager = _port_lazy(fleet, ["dense-a"], cap_mb=0), _port_eager(fleet, ["dense-a"])
    try:
        want = eager.anomaly("dense-a", X)
        for _ in range(3):
            _assert_equal(lazy.anomaly("dense-a", X), want)
        stats = lazy.host_cache.stats()
        assert not stats["enabled"] and stats["loads"] == 3 and stats["hits"] == 0
        assert stats["entries"] == 0 and lazy.stats()["spill"]["lazy_machines"] == 1
    finally:
        lazy.close()
        eager.close()


def test_a_dropped_bundle_reloads_and_scores_the_same(fleet):
    lazy = _port_lazy(fleet, ["lstm-ae"])
    try:
        first = lazy.anomaly("lstm-ae", X)
        assert lazy.host_cache.drop("lstm-ae") is True
        _assert_equal(lazy.anomaly("lstm-ae", X), first)
        assert lazy.host_cache.stats()["loads"] == 2
    finally:
        lazy.close()


def test_prefetch_hints_are_advisory(fleet):
    names = ["dense-a", "dense-b", "lstm-ae"]
    lazy = _port_lazy(fleet, names)
    eager = ServingEngine({"dense-a": _Machine("dense-a", fleet["dense-a"]).model}, device="cpu")
    try:
        out = lazy.prefetch(names + ["no-such-machine"])
        assert out == {"queued": 3, "skipped": 0, "unknown": 1}
        lazy.quiesce()
        assert set(lazy.host_cache.resident()) == set(names)
        assert lazy.prefetch(names[:1]) == {"queued": 0, "skipped": 1, "unknown": 0}
        # a prefetched machine serves without another store load
        loads = lazy.host_cache.stats()["loads"]
        lazy.anomaly(names[0], X)
        assert lazy.host_cache.stats()["loads"] == loads == 0
        assert lazy.host_cache.stats()["prefetches"] == 3
        # an eager engine's machines are not lazy: a hint names them unknown
        assert eager.prefetch(["dense-a"]) == {"queued": 0, "skipped": 0, "unknown": 1}
    finally:
        lazy.close()
        eager.close()


@pytest.mark.parametrize("name", ["dense-a", "lstm-ae"])
def test_chunked_spill_request_equals_the_unchunked_one(fleet, name):
    rows = np.concatenate([X, X[::-1], X])
    whole = _port_lazy(fleet, [name])
    chunked = ServingEngine({}, lazy=_lazy(fleet, [name]), host_cache_mb=64, device="cpu",
                            max_rows_dispatch=LOOKBACK + 40)
    try:
        want = whole.anomaly(name, rows)
        got = chunked.anomaly(name, rows)
        assert chunked.stats()["spill"]["requests"] > 1 == whole.stats()["spill"]["requests"]
        for field, a, b in zip(wire.SCORE_FIELDS, got, want):
            assert a.shape == b.shape, field
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=field)
    finally:
        whole.close()
        chunked.close()


def test_a_lazy_machine_the_engine_cannot_lift_goes_to_the_host_path(fleet):
    lazy = _port_lazy(fleet, ["union", "dense-a"])
    eager = _port_eager(fleet, ["union"])
    try:
        with pytest.raises(SpillNotLiftable, match="Pipeline"):
            lazy.anomaly("union", X)
        assert eager.skipped["union"] == lazy.host_path_machines()["union"]
        # cached all the same: the second request pays no store path
        with pytest.raises(SpillNotLiftable):
            lazy.anomaly("union", X)
        assert lazy.host_cache.stats()["loads"] == 1
        bundle = lazy.host_cache.peek("union")
        est = bundle["context"].model.base_estimator.regressor.steps[-1][1]
        assert est.device == lazy.device
        assert next(est.module_.parameters()).device == lazy.device
        assert lazy.cost_ledger()["host_path_machines"] == 1
        assert eager.cost_ledger()["host_path_machines"] == 1
        assert eager.stats()["host_path_machines"] == {"union": eager.skipped["union"]}
    finally:
        lazy.close()
        eager.close()


def test_close_stops_the_prefetch_worker(fleet):
    lazy = _port_lazy(fleet, ["dense-a", "dense-b"])
    lazy.prefetch(["dense-a"])
    lazy.quiesce()
    worker = lazy.host_cache._worker
    assert worker is not None and worker.is_alive()
    lazy.close()
    assert not worker.is_alive()
    # a later hint starts a worker again
    assert lazy.prefetch(["dense-b"])["queued"] == 1
    lazy.quiesce()
    assert "dense-b" in lazy.host_cache.resident()
    lazy.close()


def test_concurrent_spill_requests_racing_evictions_answer_their_own_machine(fleet):
    names = ["dense-a", "dense-b", "lstm-ae"]
    lazy, eager = _port_lazy(fleet, names), _port_eager(fleet, names)
    sizes = {name: lazy._build_bundle(name, lazy._lazy[name])[1] for name in names}
    # smaller than the two largest bundles together: loads race evictions
    lazy.host_cache = HostTierCache(int(1.5 * max(sizes.values())))
    assert sum(sizes.values()) - min(sizes.values()) > lazy.host_cache.cap_bytes
    want = {name: eager.anomaly(name, X) for name in names}
    errors = []

    def worker(i):
        for j in range(6):
            name = names[(i + j) % len(names)]
            try:
                _assert_equal(lazy.anomaly(name, X), want[name])
            except BaseException as exc:  # noqa: BLE001 - collected for the assert
                errors.append((name, exc))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range((os.cpu_count() or 4) + 4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    try:
        assert not any(thread.is_alive() for thread in threads)
        assert not errors, errors[:3]
        stats = lazy.host_cache.stats()
        assert stats["bytes"] <= stats["cap_bytes"]
        assert stats["bytes"] == sum(sizes[name] for name in lazy.host_cache.resident())
        assert stats["evictions"] > 0
    finally:
        lazy.close()
        eager.close()
