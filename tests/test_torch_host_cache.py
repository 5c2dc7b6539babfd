"""The port's host-RAM spill tier cache against the reference's, on the CPU.

Each case of the reference's ``TestHostTierCache``
(``tests/test_capacity.py``) runs on both packages' ``HostTierCache``:
LRU order, one put evicting many, an entry larger than the whole cap
served but never cached, a cap of 0 disabling the tier cleanly, a
replacing put keeping the byte ledger, an asynchronous prefetch, and the
prefetch racing a drop. Below them, what the port adds: ``close`` stops
the prefetch worker (and a later hint starts one), and the events land in
the port's registry under the reference's series names.
"""

import threading

import pytest

pytest.importorskip("torch")

from gordo_components_tpu.server.host_cache import HostTierCache as RefCache  # noqa: E402

from gordo_components_tpu_torch.observability.registry import REGISTRY  # noqa: E402
from gordo_components_tpu_torch.server.host_cache import HostTierCache  # noqa: E402

IMPLS = {"port": HostTierCache, "reference": RefCache}


def lru_eviction_order(cls):
    cache = cls(cap_bytes=300)
    cache.put("a", "A", 100)
    cache.put("b", "B", 100)
    cache.put("c", "C", 100)
    assert cache.resident() == ("a", "b", "c")
    # a touch moves "a" to the young end: the next over-cap put evicts "b"
    assert cache.get("a") == "A"
    cache.put("d", "D", 100)
    assert cache.resident() == ("c", "a", "d")
    assert cache.get("b") is None
    assert cache.evictions == 1
    assert cache.stats()["bytes"] == 300


def one_put_can_evict_many(cls):
    cache = cls(cap_bytes=300)
    for name in ("a", "b", "c"):
        cache.put(name, name.upper(), 100)
    cache.put("big", "BIG", 250)
    assert cache.resident() == ("big",)
    assert cache.evictions == 3


def oversize_entry_served_uncached(cls):
    cache = cls(cap_bytes=100)
    assert cache.put("whale", "W", 101) is False
    assert cache.get("whale") is None
    # nor does it flush the tier
    cache.put("a", "A", 50)
    assert cache.put("whale", "W", 101) is False
    assert cache.resident() == ("a",)
    assert cache.get_or_load("whale", lambda: ("W", 101)) == "W"
    assert cache.resident() == ("a",)


def cap_zero_disables_cleanly(cls):
    cache = cls(cap_bytes=0)
    assert not cache.enabled
    assert cache.put("a", "A", 10) is False
    assert cache.get("a") is None
    assert cache.prefetch("a", lambda: ("A", 10)) is False
    loads = []
    for _ in range(3):
        assert cache.get_or_load("a", lambda: (loads.append(1) or "A", 10)) == "A"
    assert len(loads) == 3
    assert cache.stats()["entries"] == 0


def replacing_put_updates_byte_ledger(cls):
    cache = cls(cap_bytes=300)
    cache.put("a", "A", 100)
    cache.put("a", "A2", 250)
    assert cache.stats()["bytes"] == 250
    assert cache.get("a") == "A2"
    cache.drop("a")
    assert cache.stats()["bytes"] == 0


def prefetch_loads_async(cls):
    cache = cls(cap_bytes=1 << 20)
    assert cache.prefetch("a", lambda: ("A", 10)) is True
    assert cache.quiesce(timeout=10.0)
    # a hint for a cached name is a counted skip
    assert cache.prefetch("a", lambda: ("A", 10)) is False
    assert cache.get("a") == "A"
    assert cache.stats()["prefetches"] == 1


def prefetch_race_with_drop(cls):
    """A drop() while a prefetch load is in flight ends consistent: the
    load re-caches fresh bytes, the ledger balances, a later drop clears."""
    cache = cls(cap_bytes=1 << 20)
    loading, release = threading.Event(), threading.Event()

    def slow_load():
        loading.set()
        assert release.wait(10.0)
        return "FRESH", 64

    assert cache.prefetch("m", slow_load) is True
    assert loading.wait(10.0)
    assert cache.drop("m") is False  # nothing cached yet
    release.set()
    assert cache.quiesce(timeout=10.0)
    assert cache.get("m") == "FRESH"
    assert cache.stats()["bytes"] == 64
    assert cache.drop("m") is True
    assert cache.stats()["bytes"] == 0
    assert cache.stats()["entries"] == 0


CASES = {fn.__name__: fn for fn in (
    lru_eviction_order, one_put_can_evict_many, oversize_entry_served_uncached,
    cap_zero_disables_cleanly, replacing_put_updates_byte_ledger, prefetch_loads_async,
    prefetch_race_with_drop,
)}


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_host_tier_cache(case, impl):
    CASES[case](IMPLS[impl])


def test_stats_keys_match_the_reference():
    ours, ref = HostTierCache(1 << 20), RefCache(1 << 20)
    for cache in (ours, ref):
        cache.put("a", "A", 10)
        cache.get("a")
        cache.get("b")
    assert ours.stats().keys() == ref.stats().keys()
    assert {k: v for k, v in ours.stats().items() if not k.endswith("latency_s")} == {
        k: v for k, v in ref.stats().items() if not k.endswith("latency_s")}


def test_close_stops_the_worker_and_a_later_hint_starts_one():
    cache = HostTierCache(1 << 20)
    assert cache.prefetch("a", lambda: ("A", 1))
    assert cache.quiesce(timeout=10.0)
    worker = cache._worker
    assert worker is not None and worker.is_alive()
    cache.close()
    assert not worker.is_alive()
    cache.close()  # idempotent
    assert cache.prefetch("b", lambda: ("B", 1))
    assert cache.quiesce(timeout=10.0)
    assert cache.resident() == ("a", "b")
    cache.close()


def test_events_land_in_the_registry():
    events = REGISTRY.counter("gordo_engine_host_cache_events_total", labels=("event",))
    before = dict(events.collect())
    cache = HostTierCache(cap_bytes=200)
    cache.get_or_load("a", lambda: ("A", 100))  # miss, store
    cache.get("a")  # hit
    cache.put("b", "B", 150)  # evicts a
    cache.put("c", "C", 300)  # oversize
    delta = {key[0]: value - before.get(key, 0.0) for key, value in events.collect().items()}
    assert {k: delta.get(k, 0.0) for k in ("miss", "store", "hit", "evict", "oversize")} == {
        "miss": 1, "store": 1, "hit": 1, "evict": 1, "oversize": 1}
    assert REGISTRY.gauge("gordo_engine_host_cache_bytes").collect()[()] == 150
