"""The port's traffic accounting against the reference's, on the CPU.

The same Zipf-skewed request streams, drawn with numpy from a seed, go
through both packages' ``SpaceSaving`` sketches, which must agree exactly:
``items()``, ``top(k)``, each estimate, and sketches merged across shards.
Both ``TrafficAccountant``s, fed the same notes and ticked on the same
injected clock, give the same snapshot, EWMA rates within 1e-12. With each
package's provider set, both ``bound_machine_cardinality`` keep the same
machines (the ones the sketch nominates, not the family's own ranking);
with accounting off, both fall back to the family's ranking.
"""

import numpy as np
import pytest

from gordo_components_tpu.observability import registry as ref_registry
from gordo_components_tpu.observability import traffic as ref_traffic

from gordo_components_tpu_torch.observability import registry, traffic

RATE_ATOL = 1e-12


def zipf_stream(seed, n_keys, n, skew=1.0):
    """``n`` machine names drawn with P(i) ~ 1/(i+1)**skew."""
    rng = np.random.default_rng(seed)
    weights = 1.0 / np.arange(1, n_keys + 1) ** skew
    draws = rng.choice(n_keys, size=n, p=weights / weights.sum())
    return [f"m-{i:04d}" for i in draws]


class FakeClock:
    def __init__(self, now=1000.0):
        self.now = now

    def __call__(self):
        return self.now


CASES = [(32, 400, 20000, 0), (8, 50, 5000, 1), (64, 1000, 30000, 2), (16, 16, 3000, 3)]


@pytest.mark.parametrize("capacity,n_keys,n,seed", CASES)
def test_space_saving_matches_the_reference(capacity, n_keys, n, seed):
    stream = zipf_stream(seed, n_keys, n)
    amounts = np.random.default_rng(seed + 100).integers(1, 4, size=n).astype(float)
    ours, ref = traffic.SpaceSaving(capacity), ref_traffic.SpaceSaving(capacity)
    for key, amount in zip(stream, amounts):
        ours.offer(key, amount)
        ref.offer(key, amount)
    assert ours.items() == ref.items()
    assert ours.to_list() == ref.to_list()
    for k in (0, 1, 5, capacity, capacity + 3):
        assert ours.top(k) == ref.top(k)
    for key in set(stream) | {"never-seen"}:
        assert ours.estimate(key) == ref.estimate(key)
        assert (key in ours) == (key in ref)
    assert len(ours) == len(ref) <= capacity
    # the sketch's guarantee against the true counts
    true = {}
    for key, amount in zip(stream, amounts):
        true[key] = true.get(key, 0.0) + amount
    for key, count, error in ours.items():
        assert count - error <= true[key] <= count


@pytest.mark.parametrize("capacity,n_keys,n,seed", CASES)
def test_merged_sketches_match_the_reference(capacity, n_keys, n, seed):
    stream = zipf_stream(seed, n_keys, n)
    shards = [stream[i::3] for i in range(3)]
    caps = [capacity, capacity // 2, capacity * 2]
    ours_lists, ref_lists = [], []
    for shard, cap in zip(shards, caps):
        ours, ref = traffic.SpaceSaving(cap), ref_traffic.SpaceSaving(cap)
        for key in shard:
            ours.offer(key)
            ref.offer(key)
        ours_lists.append(ours.to_list())
        ref_lists.append(ref.to_list())
    assert ours_lists == ref_lists
    for sources in (None, caps):
        ours = traffic.SpaceSaving.merged(ours_lists, capacity, source_capacities=sources)
        ref = ref_traffic.SpaceSaving.merged(ref_lists, capacity, source_capacities=sources)
        assert ours.items() == ref.items()
        assert ours.top(5) == ref.top(5)


def _feed_accountants(seed):
    """Both accountants on one fake clock: notes between ticks, with the
    serving bucket and rung of each machine."""
    clock = FakeClock()
    ours = traffic.TrafficAccountant(capacity=16, clock=clock)
    ref = ref_traffic.TrafficAccountant(capacity=16, clock=clock)
    rng = np.random.default_rng(seed)
    stream = zipf_stream(seed, 60, 4000)
    for acc in (ours, ref):
        acc.tick()  # the baseline
    for start in range(0, len(stream), 400):
        for key in stream[start:start + 400]:
            bucket = "L1440f64" if key < "m-0004" else "L1f10"
            precision = "f32" if key[-1] in "02468" else "int8"
            for acc in (ours, ref):
                acc.note(key, bucket=bucket, precision=precision)
        clock.now += float(rng.uniform(0.5, 90.0))
        for acc in (ours, ref):
            acc.tick()
    return ours, ref


def _assert_close(a, b, path="snapshot"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for key in a:
            _assert_close(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert abs(a - b) <= RATE_ATOL * max(1.0, abs(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ewma_rates_match_the_reference(seed):
    ours, ref = _feed_accountants(seed)
    snap, ref_snap = ours.snapshot(), ref.snapshot()
    _assert_close(snap, ref_snap)
    assert snap["ticks"] == ref_snap["ticks"] == 10
    assert ours.topk_names(4) == ref.topk_names(4)
    # merged views of several workers agree too
    _assert_close(traffic.merge_snapshots([snap, snap], capacity=16),
                  ref_traffic.merge_snapshots([ref_snap, ref_snap], capacity=16))


def test_a_tick_without_elapsed_time_folds_nothing():
    clock = FakeClock()
    for module in (traffic, ref_traffic):
        acc = module.TrafficAccountant(capacity=4, clock=clock)
        acc.tick()
        acc.note("a")
        acc.tick()  # dt = 0: a baseline again, not a rate
        assert acc.snapshot()["ticks"] == 0
        assert acc.snapshot()["machines"][0]["rates"] == {}


def test_note_is_a_no_op_with_telemetry_off(monkeypatch):
    monkeypatch.setenv("GORDO_TELEMETRY", "0")
    acc = traffic.TrafficAccountant(capacity=4)
    monkeypatch.setattr(traffic, "ACCOUNTANT", acc)
    traffic.note("a")
    assert acc.snapshot()["total"]["count"] == 0.0
    assert traffic._topk_provider(4) is None
    assert traffic.enabled() is ref_traffic.enabled() is False


def _machine_counter(module, name):
    reg = module.Registry()
    counter = reg.counter(name, "requests", labels=("machine", "status"))
    return reg, counter


# the family's own ranking (m-0030 busiest here) differs from the sketch's
# (m-0000 busiest over all families)
FAMILY = {f"m-{i:04d}": 100 - 2 * i for i in range(20, 40)}
FAMILY.update({f"m-{i:04d}": 1 for i in range(0, 6)})


@pytest.mark.parametrize("telemetry_on", [True, False])
def test_bound_machine_cardinality_keeps_the_same_machines(monkeypatch, telemetry_on):
    monkeypatch.setenv("GORDO_METRICS_MACHINE_CARDINALITY", "4")
    monkeypatch.setenv("GORDO_TELEMETRY", "1" if telemetry_on else "0")
    ours_acc = traffic.TrafficAccountant(capacity=32)
    ref_acc = ref_traffic.TrafficAccountant(capacity=32)
    monkeypatch.setattr(traffic, "ACCOUNTANT", ours_acc)
    monkeypatch.setattr(ref_traffic, "ACCOUNTANT", ref_acc)
    # the providers the modules installed at import
    assert registry._traffic_topk_provider is traffic._topk_provider
    assert ref_registry._traffic_topk_provider is ref_traffic._topk_provider
    for key in zipf_stream(5, 8, 3000):
        ours_acc.note(key)
        ref_acc.note(key)
    kept = []
    for module, reg_module in ((registry, registry), (ref_registry, ref_registry)):
        _, counter = _machine_counter(reg_module, "gordo_test_requests_total")
        for machine, n in sorted(FAMILY.items()):
            counter.labels(machine, "200").inc(n)
        bounded = module.bound_machine_cardinality(counter, counter.collect())
        kept.append(sorted(key[0] for key in bounded))
        assert sum(bounded.values()) == sum(FAMILY.values())
    assert kept[0] == kept[1]
    named = [m for m in kept[0] if m != "other"]
    if telemetry_on:
        # the sketch's top machines that this family has, then its ranking
        assert named == ["m-0000", "m-0001", "m-0002", "m-0003"]
    else:
        assert named == ["m-0020", "m-0021", "m-0022", "m-0023"]


def test_a_raising_provider_falls_back_to_the_family_ranking(monkeypatch):
    monkeypatch.setenv("GORDO_METRICS_MACHINE_CARDINALITY", "2")

    def broken(cap):
        raise RuntimeError("sketch down")

    monkeypatch.setattr(registry, "_traffic_topk_provider", broken)
    _, counter = _machine_counter(registry, "gordo_test_broken_total")
    for machine, n in (("a", 5), ("b", 9), ("c", 1)):
        counter.labels(machine, "200").inc(n)
    kept = {key[0] for key in registry.bound_machine_cardinality(counter, counter.collect())}
    assert kept == {"a", "b", "other"}
