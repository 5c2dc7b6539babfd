"""The fleet-sharded serving mesh's layout: which shard owns which machine
(the port's copy of ``gordo_components_tpu/parallel/shard_plan.py``).

Three layout points exist per bucket:

- **replicated** — one process's card holds the whole stacked tree (the
  default);
- **host-sharded** — the stacked machine axis shards over one host's
  local devices (``--shard-fleet``; not ported yet);
- **fleet-sharded** — the stacked machine axis partitions across N server
  processes by ring position (this module): each shard's process stacks
  ONLY the machines it owns, serves them through the unchanged pipelined,
  fused engine, and covers every other shard's machines through the
  host-RAM spill tier (the fallback rung).

The plan is a pure function of ``(machine name, n_shards, vnodes)`` —
SHA-1 ring points, the same construction as router placement — so the
router and every worker compute the IDENTICAL layout independently:
nothing is threaded through config, a restarted process re-derives its
slice, and changing the shard count moves ~1/N of the machines (bounded
movement, inherited from the ring). No collective runs between the
shards on the serving path. For a machine axis split over the ranks of a
``torch.distributed`` group, the plan also yields the padded global
machine axis (``padded_height``) and its contiguous per-shard slices
(``shard_bounds``). The reference's ``global_sharding`` returns a
``NamedSharding`` over a multi-process mesh; the port has no such object
(:mod:`.mesh`): a rank holds its ``shard_bounds`` block itself, so that
method has no counterpart.

Nothing here imports ``torch`` (``padded_height`` reads :mod:`.mesh`
lazily): the router's process, which never touches the card, resolves
the same plan as its workers.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..analysis import lockcheck

logger = logging.getLogger(__name__)

# ring points per shard — matches router placement's default so the two
# layout axes have the same distribution quality
SHARD_VNODES = 64

POLICY_SHARDED = "sharded"
POLICY_REPLICATED = "replicated"


def shard_name(shard: int) -> str:
    """The ring-member name of shard ``shard`` — the stable identity the
    layout hashes against (worker names/pids must not move machines)."""
    return f"shard-{int(shard)}"


def worker_shard(worker_id: int, n_shards: int) -> int:
    """Which shard a worker slot serves: round-robin cover, so W workers
    over S shards tile evenly (the common case is W == S) and an elastic
    scale-up lands on the least-covered shard by construction."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return int(worker_id) % int(n_shards)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return int(raw)
    except (TypeError, ValueError):
        logger.warning("%s=%r is not an int; using %d", name, raw, default)
        return default


def mesh_shards_env() -> int:
    """``GORDO_MESH_SHARDS``: total shard count of the serving mesh; 0
    (the default) means single-host serving, exactly as before."""
    return max(0, _env_int("GORDO_MESH_SHARDS", 0))


def mesh_shard_env() -> Optional[int]:
    """``GORDO_MESH_SHARD``: THIS process's shard id (0-based); unset
    means derive from the worker id (see ``worker_shard``)."""
    raw = os.environ.get("GORDO_MESH_SHARD")
    if raw is None or not raw.strip():
        return None
    try:
        return int(raw)
    except (TypeError, ValueError):
        logger.warning("GORDO_MESH_SHARD=%r is not an int; ignoring", raw)
        return None


class FleetShardPlan:
    """Deterministic machine→shard layout over an ``n_shards``-process
    serving mesh.

    Shard ids join a consistent-hash ring (``SHARD_VNODES`` SHA-1 points
    each); a machine belongs to the shard owning its ring position. The
    POLICY is declared, not hand-threaded: fleets smaller than
    ``min_shard_machines`` (``GORDO_MESH_MIN_SHARD_MACHINES``, default
    2×shards) stay REPLICATED — every shard owns the whole fleet, because
    below that size the split costs more than it frees — and larger fleets
    shard by ring position. Instances are immutable after construction, so
    reads (placement's per-request ``shard_of``) need no lock."""

    def __init__(
        self,
        n_shards: int,
        min_shard_machines: Optional[int] = None,
        vnodes: int = SHARD_VNODES,
    ):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        # the ring construction is router/placement.py's — the layout
        # axis IS the placement ring, one level down (imported lazily, as
        # the reference does)
        from ..router.placement import HashRing

        self.n_shards = int(n_shards)
        if min_shard_machines is None:
            min_shard_machines = _env_int(
                "GORDO_MESH_MIN_SHARD_MACHINES", 2 * self.n_shards
            )
        self.min_shard_machines = max(0, int(min_shard_machines))
        self.vnodes = int(vnodes)
        self._ring = HashRing(
            (shard_name(i) for i in range(self.n_shards)), vnodes=vnodes
        )

    # -- machine-axis layout -------------------------------------------------
    def shard_of(self, machine: str) -> int:
        """The shard owning ``machine``'s ring position. Pure arithmetic
        (one bisect over an immutable ring) — safe on the router's
        per-request path under its placement lock."""
        owner = self._ring.primary(machine)
        return int(owner.rsplit("-", 1)[1])

    def policy(self, fleet_size: int) -> str:
        """Which layout point the declared policy picks for a fleet of
        ``fleet_size`` machines."""
        if self.n_shards > 1 and fleet_size >= self.min_shard_machines:
            return POLICY_SHARDED
        return POLICY_REPLICATED

    def assign(self, machines: Sequence[str]) -> Dict[str, int]:
        """machine → owning shard for the whole fleet (sharded policy
        view; replicated fleets should call :meth:`owned` instead)."""
        return {name: self.shard_of(name) for name in machines}

    def owned(self, machines: Sequence[str], shard: int) -> List[str]:
        """The machines shard ``shard`` stacks eagerly, policy applied:
        a replicated fleet is owned EVERYWHERE (each process serves any
        machine from its own stacked tree), a sharded fleet partitions
        by ring position."""
        if not 0 <= int(shard) < self.n_shards:
            raise ValueError(
                f"shard {shard} outside the {self.n_shards}-shard mesh"
            )
        if self.policy(len(machines)) == POLICY_REPLICATED:
            return sorted(machines)
        return sorted(m for m in machines if self.shard_of(m) == int(shard))

    def counts(self, machines: Sequence[str]) -> List[int]:
        """Machines per shard under the sharded policy — the balance an
        operator reads."""
        counts = [0] * self.n_shards
        for name in machines:
            counts[self.shard_of(name)] += 1
        return counts

    # -- the machine axis over ranks -----------------------------------------
    def padded_height(self, n_machines: int) -> int:
        """Global stacked machine-axis length, padded so it divides
        evenly across the shards (``pad_to_multiple`` — padding slots
        repeat a live machine and are never dispatched)."""
        from .mesh import pad_to_multiple

        return pad_to_multiple(max(1, int(n_machines)), self.n_shards)

    def shard_bounds(self, n_machines: int) -> List[Tuple[int, int]]:
        """Contiguous ``[lo, hi)`` slices of the padded global machine
        axis, one per shard — the block each rank of a group holds."""
        height = self.padded_height(n_machines)
        per = height // self.n_shards
        return [(i * per, (i + 1) * per) for i in range(self.n_shards)]

    def describe(self) -> Dict[str, Any]:
        return {
            "shards": self.n_shards,
            "vnodes": self.vnodes,
            "min_shard_machines": self.min_shard_machines,
        }


# one plan per (shards, threshold) per process: the ring build hashes
# n_shards x vnodes points, and boot + every reload + the router all
# resolve the same layout — cache it instead of re-deriving per call
_PLAN_LOCK = lockcheck.named_lock("parallel.shard_plan")
_PLAN_CACHE: Dict[Tuple[int, int], FleetShardPlan] = {}


def resolve_plan(
    n_shards: Optional[int] = None,
    min_shard_machines: Optional[int] = None,
) -> Optional[FleetShardPlan]:
    """The process's serving-mesh layout, env-resolved: ``None`` when
    mesh serving is off (``GORDO_MESH_SHARDS`` unset/0), else the cached
    deterministic plan."""
    if n_shards is None:
        n_shards = mesh_shards_env()
    if not n_shards or n_shards < 1:
        return None
    if min_shard_machines is None:
        min_shard_machines = _env_int(
            "GORDO_MESH_MIN_SHARD_MACHINES", 2 * int(n_shards)
        )
    key = (int(n_shards), int(min_shard_machines))
    with _PLAN_LOCK:
        lockcheck.assert_guard("parallel.shard_plan")
        plan = _PLAN_CACHE.get(key)
        if plan is None:
            plan = FleetShardPlan(key[0], key[1])
            _PLAN_CACHE[key] = plan
        return plan
