"""The port's consistent-hash placement against the reference's, on the CPU.

First the reference's own ring and placement cases (``tests/test_router.py``:
determinism across restarts, spread, bounded movement on leave, join and
weight changes, distinct preference lists, hot replication, rotation, rate
promotion with hysteresis, deterministic tables) and the probe jitter's
bounds, run on the port's classes. Then parity: for the same worker names
and 200 machine names, the port's ``Placement.table()`` and
``HashRing.preference(key, n)`` equal the reference's exactly (both hash
with SHA-1), after ``add``, ``remove`` and ``set_weight`` too, and the
candidate walks (rotation and failover tail included) agree call for call.
"""

import pytest

from gordo_components_tpu.router import placement as ref_placement

from gordo_components_tpu_torch.router import HashRing, Placement, jittered_interval

KEYS = [f"machine-{i:03d}" for i in range(200)]
WORKERS = [f"worker-{i}" for i in range(5)]


def test_ring_deterministic_across_restarts():
    """Placement is a pure function of (workers, key): a rebuilt ring — a
    restarted router — computes the identical table, so restarts cause
    zero residency churn."""
    workers = ["worker-0", "worker-1", "worker-2", "worker-3"]
    first = {key: HashRing(workers).primary(key) for key in KEYS}
    second = {key: HashRing(list(reversed(workers))).primary(key)
              for key in KEYS}
    assert first == second
    # replica sets too, not just primaries
    ring_a, ring_b = HashRing(workers), HashRing(workers)
    for key in KEYS[:50]:
        assert ring_a.preference(key, 3) == ring_b.preference(key, 3)


def test_ring_spreads_keys():
    ring = HashRing(["worker-0", "worker-1", "worker-2", "worker-3"])
    owners = {key: ring.primary(key) for key in KEYS}
    counts = {w: sum(1 for o in owners.values() if o == w)
              for w in ring.workers()}
    assert set(counts) == {"worker-0", "worker-1", "worker-2", "worker-3"}
    # 200 keys over 4 workers: every worker owns a real share (the bound
    # is loose — vnodes=64 keeps the spread far tighter in practice)
    assert all(count >= 20 for count in counts.values()), counts


def test_ring_bounded_movement_on_leave():
    """Removing a worker moves ONLY the keys it owned; every other key's
    placement is untouched (the property that keeps an eject from
    cold-starting the whole fleet's residency)."""
    ring = HashRing(["worker-0", "worker-1", "worker-2"])
    before = {key: ring.primary(key) for key in KEYS}
    ring.remove("worker-1")
    for key in KEYS:
        after = ring.primary(key)
        if before[key] == "worker-1":
            assert after != "worker-1"
        else:
            assert after == before[key], f"{key} moved without cause"


def test_ring_bounded_movement_on_join():
    """A joining worker only STEALS keys; no key moves between
    incumbents."""
    ring = HashRing(["worker-0", "worker-1", "worker-2"])
    before = {key: ring.primary(key) for key in KEYS}
    ring.add("worker-3")
    moved = 0
    for key in KEYS:
        after = ring.primary(key)
        if after != before[key]:
            assert after == "worker-3", f"{key} moved between incumbents"
            moved += 1
    # it must actually take ~1/4 of the keyspace, not nothing
    assert 10 <= moved <= 120, moved


def test_ring_preference_distinct_and_ordered():
    ring = HashRing(["worker-0", "worker-1", "worker-2"])
    for key in KEYS[:50]:
        pref = ring.preference(key, 3)
        assert len(pref) == 3 and len(set(pref)) == 3
        assert pref[0] == ring.primary(key)
    # n beyond the worker count returns them all, once
    assert len(ring.preference("machine-000", 10)) == 3


# -- weighted arcs (layout plans) ---------------------------------------

def test_ring_weight_shifts_share_with_bounded_movement():
    """Raising one worker's weight grows its key share, and ONLY keys
    flowing to/from that worker move — incumbents never trade keys
    among themselves (the property that lets a layout plan rebalance a
    live fleet without a residency cold start)."""
    ring = HashRing(["worker-0", "worker-1", "worker-2"])
    before = {key: ring.primary(key) for key in KEYS}
    share_before = sum(1 for o in before.values() if o == "worker-1")
    assert ring.set_weight("worker-1", 2.0) is True
    after = {key: ring.primary(key) for key in KEYS}
    share_after = sum(1 for o in after.values() if o == "worker-1")
    assert share_after > share_before
    for key in KEYS:
        if before[key] != after[key]:
            assert after[key] == "worker-1", f"{key} moved between others"
    # shrinking back: only worker-1's keys are shed
    ring.set_weight("worker-1", 0.5)
    shrunk = {key: ring.primary(key) for key in KEYS}
    for key in KEYS:
        if after[key] != shrunk[key]:
            assert after[key] == "worker-1", f"{key} moved without cause"


def test_ring_weight_is_deterministic_and_clamped():
    a = HashRing(["worker-0", "worker-1"])
    b = HashRing(["worker-1", "worker-0"])
    a.set_weight("worker-0", 1.5)
    b.set_weight("worker-0", 1.5)
    assert {k: a.primary(k) for k in KEYS} == {k: b.primary(k) for k in KEYS}
    # same value again: no-op, no version churn
    version = a.version
    assert a.set_weight("worker-0", 1.5) is False
    assert a.version == version
    # the guard rails: a weight cannot starve or monopolize the ring
    a.set_weight("worker-1", 0.001)
    assert a.weights()["worker-1"] == pytest.approx(0.1)
    a.set_weight("worker-1", 100.0)
    assert a.weights()["worker-1"] == pytest.approx(8.0)


def test_placement_set_worker_weights_reverts_absent():
    """The reconciler seam: declared weights win, workers missing from
    the new declaration revert to 1.0 (how rollback clears a plan)."""
    placement = Placement(
        ["worker-0", "worker-1", "worker-2"], hot_rps=0,
    )
    assert placement.set_worker_weights(
        {"worker-0": 2.0, "worker-2": 0.5}
    ) is True
    assert placement.worker_weights() == {
        "worker-0": 2.0, "worker-2": 0.5,
    }
    assert placement.stats()["weights"] == {
        "worker-0": 2.0, "worker-2": 0.5,
    }
    # idempotent re-apply: the reconciler converges, it never churns
    assert placement.set_worker_weights(
        {"worker-0": 2.0, "worker-2": 0.5}
    ) is False
    assert placement.set_worker_weights({}) is True
    assert placement.worker_weights() == {}


# -- placement: hot replication ----------------------------------------------

def test_placement_replication_fanout():
    """A hot machine fans out over `replicas` distinct workers; cold
    machines stay pinned to exactly one."""
    placement = Placement(
        ["worker-0", "worker-1", "worker-2"], replicas=2,
        hot_rps=0, hot=["machine-007"],
    )
    assert len(placement.replica_set("machine-007")) == 2
    assert len(placement.replica_set("machine-001")) == 1
    # candidates: the full failover tail follows the replica set
    assert len(placement.candidates("machine-001")) == 3


def test_placement_hot_rotation():
    """Successive candidate lists for a hot machine rotate the replica
    set, spreading its load; the replica MEMBERSHIP stays fixed."""
    placement = Placement(
        ["worker-0", "worker-1", "worker-2"], replicas=2,
        hot_rps=0, hot=["machine-007"],
    )
    replica_set = set(placement.replica_set("machine-007"))
    firsts = {placement.candidates("machine-007")[0] for _ in range(6)}
    assert firsts == replica_set  # both replicas take the lead in turn
    for _ in range(4):
        assert set(placement.candidates("machine-007")[:2]) == replica_set


def test_placement_rate_promotion_and_hysteresis():
    clock = {"now": 0.0}
    placement = Placement(
        ["worker-0", "worker-1"], replicas=2,
        hot_rps=10.0, hot_window_s=1.0, clock=lambda: clock["now"],
    )
    # 20 requests in one window = 20 rps -> hot
    for _ in range(20):
        placement.note_request("machine-001")
        clock["now"] += 0.04
    assert placement.is_hot("machine-001")
    # rate decays below half the threshold -> demoted (hysteresis)
    clock["now"] += 5.0
    placement.note_request("machine-001")
    assert not placement.is_hot("machine-001")


def test_placement_table_deterministic():
    a = Placement(["worker-0", "worker-1", "worker-2"], hot_rps=0)
    b = Placement(["worker-2", "worker-1", "worker-0"], hot_rps=0)
    assert a.table(KEYS[:40]) == b.table(KEYS[:40])


# -- probe jitter ------------------------------------------------------------

def test_jittered_interval_bounds():
    """±10% exactly at the extremes, never outside (the thundering herd): injectable rng pins the bounds instead of sampling."""
    assert jittered_interval(2.0, rng=lambda a, b: a) == pytest.approx(1.8)
    assert jittered_interval(2.0, rng=lambda a, b: b) == pytest.approx(2.2)
    assert jittered_interval(2.0, rng=lambda a, b: 0.0) == pytest.approx(2.0)
    for _ in range(100):
        assert 1.8 <= jittered_interval(2.0) <= 2.2
    assert jittered_interval(0.0) == 0.0


# -- parity with the reference ------------------------------------------------

def _rings():
    return HashRing(WORKERS), ref_placement.HashRing(WORKERS)


def _same_ring(ours, theirs):
    assert ours.workers() == theirs.workers()
    assert ours.version == theirs.version
    assert ours.weights() == theirs.weights()
    for n in (1, 2, 3, 7):
        assert [ours.preference(k, n) for k in KEYS] == [theirs.preference(k, n) for k in KEYS]


@pytest.mark.parametrize("mutation", [
    "none",
    "add",
    "remove",
    "set_weight",
    "weight_then_leave_and_rejoin",
])
def test_ring_preference_equals_the_reference(mutation):
    ours, theirs = _rings()
    steps = {
        "none": [],
        "add": [("add", "worker-9"), ("add", "worker-10")],
        "remove": [("remove", "worker-2")],
        "set_weight": [("set_weight", "worker-1", 2.5), ("set_weight", "worker-3", 0.4)],
        "weight_then_leave_and_rejoin": [("set_weight", "worker-4", 3.0), ("remove", "worker-4"),
                                         ("add", "worker-4"), ("set_weight", "worker-0", 0.05)],
    }[mutation]
    for name, *args in steps:
        assert getattr(ours, name)(*args) == getattr(theirs, name)(*args)
    _same_ring(ours, theirs)


def test_placement_table_and_candidates_equal_the_reference():
    clock = {"now": 0.0}
    kwargs = dict(replicas=2, hot_rps=10.0, hot_window_s=1.0, hot=["machine-007"],
                  clock=lambda: clock["now"])
    ours = Placement(WORKERS, **kwargs)
    theirs = ref_placement.Placement(WORKERS, **kwargs)
    assert ours.table(KEYS) == theirs.table(KEYS)
    # the same traffic promotes the same machines on both sides
    for i in range(60):
        for placement in (ours, theirs):
            placement.note_request(KEYS[i % 3])
        clock["now"] += 0.01
    assert ours.hot_machines() == theirs.hot_machines()
    assert ours.stats() == theirs.stats()
    # rotation and the failover tail, call for call
    for key in KEYS[:20] + ["machine-007"] * 4:
        assert ours.candidates(key) == theirs.candidates(key)
    for placement in (ours, theirs):
        placement.remove_worker("worker-1")
        placement.add_worker("worker-7")
        placement.set_worker_weights({"worker-0": 2.0})
    assert ours.table(KEYS) == theirs.table(KEYS)
    assert ours.workers() == theirs.workers()
