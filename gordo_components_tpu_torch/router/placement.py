"""Consistent-hash machine→worker placement with hot-machine replication
(the port's copy of ``gordo_components_tpu/router/placement.py``). A
fleet-sharded mesh router (``router.assemble_fleet(mesh_shards=N)``) sets
the shard table through ``set_mesh``; the elastic tier records a new
worker's shard through ``mesh_shard_for`` and ``set_worker_shard``.

Why placement instead of round-robin: every worker process owns its own
serving engine — device-resident stacked params, per-bucket megabatch
residency, and a warmed program set. Spraying a machine's requests across
all workers would cold-start that machine's residency everywhere and let
it go stale everywhere; pinning each machine to ONE worker keeps the
stacked weights and megabatch residency warm exactly where that machine's
traffic lands. Mesh-TensorFlow frames batch splitting as one point in a
layout space (PAPERS.md); machine→worker assignment is the same kind of
layout axis, one level up the serving tier.

The ring is the classic consistent-hash construction (SHA-1 points,
``vnodes`` virtual nodes per worker) with the two properties the fleet
needs:

- **deterministic** — placement is a pure function of (worker names,
  machine name, vnodes). A restarted router computes the identical table,
  so a restart never causes fleet-wide residency churn.
- **bounded movement** — removing a worker moves ONLY the keys that lived
  on it (they redistribute over the survivors); adding one steals ~1/N of
  each incumbent's keys and moves nothing between incumbents.

**Hot-machine replication**: a machine whose observed request rate
crosses ``hot_rps`` (or that is pinned hot by config) is served by its
first ``replicas`` distinct ring workers instead of one, with requests
rotated among them — the single-worker ceiling must not become one hot
machine's ceiling. Replica sets are ring prefixes, so they inherit both
properties above.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence

from ..analysis import lockcheck



def _hash64(key: str) -> int:
    """Stable 64-bit ring coordinate. SHA-1, not ``hash()``: Python string
    hashing is salted per process (PYTHONHASHSEED), which would scramble
    placement on every restart — the one property this module exists to
    prevent."""
    return int.from_bytes(
        hashlib.sha1(key.encode("utf-8")).digest()[:8], "big"
    )


class HashRing:
    """Sorted ring of (point, worker) pairs, ``vnodes`` points per worker.

    Not thread-safe by itself; :class:`Placement` wraps mutations in its
    own lock (ring membership changes are rare — worker eject/join — and
    lookups dominate).

    **Weighted overrides** (the layout compiler's seam, §27): a declared
    per-worker weight scales that worker's point count —
    ``max(1, round(vnodes * weight))`` — so a measured-load plan can
    shift ring share without forking the ring. Declared weights win over
    the uniform vnode count; changing one worker's weight adds or
    removes ONLY that worker's points, so key movement is bounded by the
    resized arcs exactly as for a join/leave.
    """

    def __init__(self, workers: Iterable[str] = (), vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = int(vnodes)
        self._points: List[int] = []
        self._owners: List[str] = []
        self._workers: set = set()
        self._weights: Dict[str, float] = {}
        self._point_counts: Dict[str, int] = {}
        # membership version: bumped on every add/remove so callers
        # (Placement) can cache membership-derived views — a join/leave
        # invalidates exactly once, lookups between them are cache hits
        self.version = 0
        for worker in workers:
            self.add(worker)

    # weight clamp: a zero/negative weight would unmap the worker
    # entirely (routing around a live worker is membership's job, not a
    # weight's), and an unbounded one would swamp the ring
    WEIGHT_MIN = 0.1
    WEIGHT_MAX = 8.0

    def _target_count(self, worker: str) -> int:
        weight = self._weights.get(worker, 1.0)
        return max(1, int(round(self.vnodes * weight)))

    def _worker_points(self, worker: str, count: Optional[int] = None) -> List[int]:
        n = self._target_count(worker) if count is None else count
        return [_hash64(f"{worker}#{i}") for i in range(n)]

    def _merge_points(self, worker: str, incoming: List[int]) -> None:
        """ONE sorted merge of ``incoming`` (sorted) into the arrays —
        O(P + v), not the O(v·P) of v independent ``list.insert``
        memmoves."""
        merged_points: List[int] = []
        merged_owners: List[str] = []
        i = j = 0
        while i < len(self._points) and j < len(incoming):
            if self._points[i] <= incoming[j]:
                merged_points.append(self._points[i])
                merged_owners.append(self._owners[i])
                i += 1
            else:
                merged_points.append(incoming[j])
                merged_owners.append(worker)
                j += 1
        merged_points.extend(self._points[i:])
        merged_owners.extend(self._owners[i:])
        merged_points.extend(incoming[j:])
        merged_owners.extend([worker] * (len(incoming) - j))
        self._points = merged_points
        self._owners = merged_owners

    def add(self, worker: str) -> None:
        """Incremental join (§22): one sorted merge of the worker's
        points into the arrays. Only the joining worker's arcs change
        ownership; incumbent points are untouched (the bounded-movement
        property is structural). A weight declared before the join is
        honored here."""
        if worker in self._workers:
            return
        self._workers.add(worker)
        self.version += 1
        count = self._target_count(worker)
        self._point_counts[worker] = count
        self._merge_points(worker, sorted(self._worker_points(worker, count)))

    def set_weight(self, worker: str, weight: float) -> bool:
        """Declare ``worker``'s ring weight (1.0 = the uniform default).
        Declared weights win over the vnode count: the worker's point
        set becomes ``worker#0..worker#k-1`` for ``k = max(1,
        round(vnodes * weight))``. Because point names are stable, a
        resize touches ONLY the delta range ``worker#min(old,new)..`` —
        grow merges those points in, shrink filters exactly them out —
        so key movement is bounded by the resized arcs (the same
        structural guarantee as join/leave; proven in
        tests/test_placement.py). Returns True when the ring changed."""
        weight = min(self.WEIGHT_MAX, max(self.WEIGHT_MIN, float(weight)))
        if weight == 1.0:
            self._weights.pop(worker, None)
        else:
            self._weights[worker] = weight
        if worker not in self._workers:
            return False
        old_count = self._point_counts.get(worker, self.vnodes)
        new_count = self._target_count(worker)
        if new_count == old_count:
            return False
        self.version += 1
        self._point_counts[worker] = new_count
        if new_count > old_count:
            grown = sorted(
                _hash64(f"{worker}#{i}") for i in range(old_count, new_count)
            )
            self._merge_points(worker, grown)
        else:
            shed = {
                _hash64(f"{worker}#{i}") for i in range(new_count, old_count)
            }
            keep = [
                (point, owner)
                for point, owner in zip(self._points, self._owners)
                if not (owner == worker and point in shed)
            ]
            self._points = [point for point, _ in keep]
            self._owners = [owner for _, owner in keep]
        return True

    def weights(self) -> Dict[str, float]:
        """Non-default declared weights (1.0 entries are elided)."""
        return dict(self._weights)

    def remove(self, worker: str) -> None:
        """Incremental leave: one filtering pass dropping ONLY the
        departed worker's points — its arcs fall to their clockwise
        successors, nothing moves between survivors."""
        if worker not in self._workers:
            return
        self._workers.discard(worker)
        self._point_counts.pop(worker, None)
        # the declared weight is sticky across leave/rejoin: a respawned
        # worker slot re-enters the ring at its planned share
        self.version += 1
        keep = [
            (point, owner)
            for point, owner in zip(self._points, self._owners)
            if owner != worker
        ]
        self._points = [point for point, _ in keep]
        self._owners = [owner for _, owner in keep]

    def workers(self) -> List[str]:
        return sorted(self._workers)

    def __len__(self) -> int:
        return len(self._workers)

    def primary(self, key: str) -> Optional[str]:
        """The worker owning ``key`` — first ring point clockwise of the
        key's hash. None on an empty ring."""
        owners = self.preference(key, 1)
        return owners[0] if owners else None

    def preference(self, key: str, n: int) -> List[str]:
        """The first ``n`` DISTINCT workers clockwise of ``key``'s point —
        the replica set, and (continued past ``n``) the failover order.
        Fewer than ``n`` workers on the ring returns them all."""
        if not self._points:
            return []
        n = min(n, len(self._workers))
        start = bisect.bisect_right(self._points, _hash64(key))
        found: List[str] = []
        seen: set = set()
        for i in range(len(self._points)):
            owner = self._owners[(start + i) % len(self._points)]
            if owner not in seen:
                seen.add(owner)
                found.append(owner)
                if len(found) == n:
                    break
        return found


class _RateWindow:
    """Two-bucket sliding-window request-rate estimate for one machine —
    O(1) per request, no timestamp deques (a hot machine is exactly the
    one that would make a deque expensive)."""

    __slots__ = ("window_s", "started", "count", "prev_count")

    def __init__(self, window_s: float, now: float):
        self.window_s = window_s
        self.started = now
        self.count = 0
        self.prev_count = 0

    def _rotate(self, now: float) -> None:
        elapsed = now - self.started
        if elapsed >= 2 * self.window_s:
            self.prev_count, self.count = 0, 0
            self.started = now
        elif elapsed >= self.window_s:
            self.prev_count, self.count = self.count, 0
            self.started += self.window_s

    def note(self, now: float) -> None:
        self._rotate(now)
        self.count += 1

    def rate(self, now: float) -> float:
        self._rotate(now)
        frac = (now - self.started) / self.window_s
        # weight the previous full window by how little of the current
        # one has elapsed — the standard sliding-window approximation
        estimate = self.prev_count * (1.0 - frac) + self.count
        return estimate / self.window_s


class Placement:
    """machine → ordered worker candidates, with hot-machine replication
    and per-machine rotation among replicas.

    ``replicas``: how many distinct workers serve a HOT machine (cold
    machines always get exactly one). ``hot_rps``: observed request rate
    (over ``hot_window_s``) at which a machine is promoted to hot; 0
    disables rate-based promotion. ``hot``: machines pinned hot by
    config, regardless of rate. Demotion is automatic: a pinned-free
    machine whose rate falls below half the threshold (hysteresis — no
    flapping at the boundary) drops back to single-worker placement.
    """

    def __init__(
        self,
        workers: Iterable[str] = (),
        vnodes: int = 64,
        replicas: int = 2,
        hot_rps: float = 50.0,
        hot_window_s: float = 10.0,
        hot: Iterable[str] = (),
        clock=time.monotonic,
        shard_of=None,
        worker_shards: Optional[Dict[str, int]] = None,
        mesh_shards: Optional[int] = None,
    ):
        self.ring = HashRing(workers, vnodes=vnodes)
        self.replicas = max(1, int(replicas))
        self.hot_rps = float(hot_rps)
        self.hot_window_s = float(hot_window_s)
        self._pinned_hot = set(hot)
        self._clock = clock
        self._lock = lockcheck.named_lock("router.placement")
        self._rates: Dict[str, _RateWindow] = {}
        self._hot: set = set(self._pinned_hot)
        self._rotation: Dict[str, int] = {}
        # membership list cached per ring version (§22): the failover
        # tail of candidates() reads this tuple instead of re-walking
        # (and re-sorting) anything per request
        self._order_cache = (-1, ())
        # multi-host mesh serving (§23): ``shard_of(machine) -> shard``
        # (the deterministic shard plan — pure arithmetic, immutable) and
        # the worker → shard table. When both are set, candidates()
        # stable-partitions its order so the machine's OWNING shard's
        # workers come first and everything else is the fallback rung —
        # a dead owner degrades to spill-tier serving, never to a 503.
        self._shard_of = shard_of
        self._worker_shards: Dict[str, int] = dict(worker_shards or {})
        # the mesh's TRUE shard count, declared — never inferred from
        # the live table (a retire would shrink the inference and hand
        # new elastic slots the wrong shard); immutable after boot
        self._mesh_shards: Optional[int] = (
            int(mesh_shards) if mesh_shards else None
        )

    # -- membership ----------------------------------------------------------
    def add_worker(self, worker: str) -> None:
        with self._lock:
            self.ring.add(worker)

    def remove_worker(self, worker: str) -> None:
        with self._lock:
            self.ring.remove(worker)

    def workers(self) -> List[str]:
        with self._lock:
            return self.ring.workers()

    # -- layout weights (§27) ------------------------------------------------
    def set_worker_weights(self, weights: Dict[str, float]) -> bool:
        """Install the layout plan's per-worker ring weights atomically.
        Workers absent from ``weights`` revert to the uniform 1.0
        default (so clearing a plan is ``set_worker_weights({})``).
        Returns True when any worker's point set changed."""
        changed = False
        with self._lock:
            lockcheck.assert_guard("router.placement")
            desired = {
                worker: float(weight)
                for worker, weight in (weights or {}).items()
            }
            for worker in list(self.ring.weights()):
                if worker not in desired:
                    changed |= self.ring.set_weight(worker, 1.0)
            for worker, weight in desired.items():
                changed |= self.ring.set_weight(worker, weight)
        return changed

    def worker_weights(self) -> Dict[str, float]:
        with self._lock:
            return self.ring.weights()

    # -- mesh shards (§23) ---------------------------------------------------
    def set_mesh(
        self,
        shard_of,
        worker_shards: Optional[Dict[str, int]],
        mesh_shards: Optional[int],
    ) -> bool:
        """Install (or clear, with ``None``s) the mesh layout
        atomically — the §23 policy seam. Applied at assemble time and
        RE-DERIVED after every router ``/reload``: fleet membership can
        cross the sharding threshold at runtime, and router and workers
        must flip between sharded and replicated together. Returns True
        when the policy flipped."""
        with self._lock:
            lockcheck.assert_guard("router.placement")
            was_sharded = self._shard_of is not None
            self._shard_of = shard_of
            self._worker_shards = dict(worker_shards or {})
            self._mesh_shards = int(mesh_shards) if mesh_shards else None
            return was_sharded != (shard_of is not None)

    def set_worker_shard(self, worker: str, shard: Optional[int]) -> None:
        """Record (or clear, with ``None``) which mesh shard a worker
        serves — the elastic tier registers new workers here alongside
        their ring join."""
        with self._lock:
            lockcheck.assert_guard("router.placement")
            if shard is None:
                self._worker_shards.pop(worker, None)
            else:
                self._worker_shards[worker] = int(shard)

    def shard_of(self, machine: str) -> Optional[int]:
        """The mesh shard owning ``machine`` (None = mesh serving off).
        Snapshot under the lock: set_mesh can clear the callable
        concurrently (a /reload flipping the policy)."""
        with self._lock:
            shard_of = self._shard_of
        if shard_of is None:
            return None
        return shard_of(machine)

    def mesh_shard_for(self, worker_id: int) -> Optional[int]:
        """Round-robin shard assignment for a NEW worker slot — the
        elastic tier's seam (matches ``shard_plan.worker_shard`` over
        the mesh's declared shard count, so it agrees with the
        ``--mesh-shard`` flag the spawned worker boots with); None when
        mesh serving is off. Snapshot under the lock: set_mesh clears
        both fields concurrently."""
        with self._lock:
            if self._shard_of is None or not self._mesh_shards:
                return None
            n_shards = self._mesh_shards
        return int(worker_id) % n_shards

    # -- hot tracking --------------------------------------------------------
    def note_request(self, machine: str) -> None:
        """Count one routed request toward ``machine``'s rate window and
        re-evaluate its hot/cold standing."""
        if self.hot_rps <= 0 and machine not in self._pinned_hot:
            return
        now = self._clock()
        with self._lock:
            lockcheck.assert_guard("router.placement")
            window = self._rates.get(machine)
            if window is None:
                window = self._rates[machine] = _RateWindow(
                    self.hot_window_s, now
                )
            window.note(now)
            if self.hot_rps <= 0:
                return
            rate = window.rate(now)
            if rate >= self.hot_rps:
                self._hot.add(machine)
            elif (
                machine in self._hot
                and machine not in self._pinned_hot
                and rate < self.hot_rps / 2.0
            ):
                self._hot.discard(machine)

    def is_hot(self, machine: str) -> bool:
        with self._lock:
            return machine in self._hot

    def hot_machines(self) -> List[str]:
        with self._lock:
            return sorted(self._hot)

    # -- placement -----------------------------------------------------------
    # distinct workers walked clockwise PAST the replica set — the warm
    # failover candidates a routing sweep actually reaches in practice
    _FAILOVER_PROBE = 2

    def _membership_locked(self):
        """Sorted worker tuple, cached per ring version — join/leave
        invalidates once; every lookup in between is a tuple read."""
        version = self.ring.version
        cached_version, cached = self._order_cache
        if cached_version != version:
            cached = tuple(self.ring.workers())
            self._order_cache = (version, cached)
        return cached

    def candidates(self, machine: str) -> List[str]:
        """Ordered candidate workers for ``machine``: its replica set
        (rotated per-machine so a hot machine's load spreads over its
        replicas), then a short clockwise failover probe, then every
        remaining worker (full coverage for the sweep that routes around
        a mostly-dead fleet).

        Cost per request is O(log v) — a bisect plus a bounded distinct-
        worker walk for the head, and a cached-membership rotation for
        the tail — NOT a full rescan of the N·vnodes point array (§22):
        at fleet scale this call is the router's per-request hot path."""
        with self._lock:
            n_replicas = (
                self.replicas if machine in self._hot else 1
            )
            order = self._membership_locked()
            if not order:
                return []
            head = self.ring.preference(
                machine, min(n_replicas + self._FAILOVER_PROBE, len(order))
            )
            replica_set = head[:n_replicas]
            tail = head[n_replicas:]
            if len(replica_set) > 1:
                turn = self._rotation.get(machine, 0)
                self._rotation[machine] = (turn + 1) % len(replica_set)
                replica_set = (
                    replica_set[turn:] + replica_set[:turn]
                )
            if len(head) < len(order):
                # deterministic per-machine rotation of the cached
                # membership list — same coverage the old full ring walk
                # gave, without touching the point array
                start = _hash64(machine) % len(order)
                seen = set(head)
                tail = tail + [
                    worker
                    for worker in order[start:] + order[:start]
                    if worker not in seen
                ]
            ordered = replica_set + tail
            if self._shard_of is not None and self._worker_shards:
                # §23: the owning shard's workers first (ring order kept
                # within each group — rotation/failover still apply), the
                # rest after as the spill fallback rung. One pure-
                # arithmetic shard_of call plus a stable partition: the
                # per-request cost stays O(log v).
                shard = self._shard_of(machine)
                owners = [
                    worker for worker in ordered
                    if self._worker_shards.get(worker) == shard
                ]
                if owners:
                    ordered = owners + [
                        worker for worker in ordered
                        if self._worker_shards.get(worker) != shard
                    ]
            return ordered

    def replica_set(self, machine: str) -> List[str]:
        """The UNROTATED replica set (stable view for status/tests)."""
        with self._lock:
            n = self.replicas if machine in self._hot else 1
            return self.ring.preference(machine, n)

    def table(self, machines: Sequence[str]) -> Dict[str, List[str]]:
        """Deterministic placement table for a machine list — the
        operator view ``/router/status`` serves (rotation-free)."""
        return {machine: self.replica_set(machine) for machine in machines}

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "workers": self.ring.workers(),
                "vnodes": self.ring.vnodes,
                "replicas": self.replicas,
                "hot_rps": self.hot_rps,
                "hot_machines": sorted(self._hot),
                # §27: declared layout weights (empty = uniform ring)
                "weights": dict(sorted(self.ring.weights().items())),
                # §23: worker → mesh shard (empty = mesh serving off)
                "worker_shards": dict(sorted(self._worker_shards.items())),
            }
