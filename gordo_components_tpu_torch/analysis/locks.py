"""THE declared lock order of the port — the one copy both halves check
against.

The serving system's locks form a strict hierarchy: a thread may only
acquire a lock of HIGHER rank than every lock it already holds. Rank
gaps are deliberate slack for future locks. The static checker
(:mod:`.lock_discipline`) flags source-level acquisitions that violate
it, and the runtime validator (:mod:`.lockcheck`) fails real executions
whose observed order it forbids.

Why ranks and not an edge list: a total-ish order makes every nesting
decidable (no "we never declared that pair" ambiguity), and cycles are
impossible by construction — any cycle must contain a rank inversion.

A lock the reference has keeps the reference's name and rank. The
port's own locks were ranked by reading who holds what while taking
what: a bucket's program runs under ``engine.template`` (a spilled
machine's under ``engine.spill``) and launches the flash kernels, which
count each launch under ``kernels.launch``; a library is resolved before
its first launch, under ``kernels.load``, through the kernel-library
store (``compile_cache.*``), whose commit is a fault seam; metric
series, span timelines and the flight recorder are written from under
nearly every other lock, so they rank innermost.

``HOT_LOCKS`` are the request-path locks: holding one while making a
blocking call (a wait for the device, HTTP, joins, sleeps, a kernel
library's build or load) stalls either live scoring traffic or the
dispatch pipeline behind it, so the static checker flags those calls.
Deliberate exceptions carry a ``# lint: allow-blocking(<reason>)``
comment — the reason is mandatory.

Two locks of the port are not declared, because they are local: the
IROC provider's reader-cache lock
(``dataset/data_provider/ncs_iroc.py``, held for a dict read or insert
on the build path, never across a call) and the control ledger's
``_configure_lock`` (``observability/ledger.py``, one process-wide
configure that swaps the module's ledger; neither takes another lock
while held), as in the reference.
"""

from __future__ import annotations

from typing import Dict, Tuple

# lock name -> rank. Acquisition must be strictly rank-increasing per
# thread. Locks never held together may share a rank tier spacing, but
# no two locks that can nest may share a rank.
LOCK_RANKS: Dict[str, int] = {
    # -- admin / control-plane outer locks (held across whole operations)
    "server.reload": 10,        # server.py _reload_lock: one reload at a time
    "fleet.reconcile": 11,      # reconciler.py _lock: held across repairs,
                                # which nest into every admin lock below
    "autopilot.state": 12,      # controller.py _lock: tick/decision state
    "autopilot.elastic": 13,    # elastic.py _lock: one scale op at a time
    "parallel.shard_plan": 14,  # shard_plan.py plan cache (boot/reload/router)
    "router.op": 15,            # rollout.py _op_lock: one rollout/rollback
    "fleet.spec": 16,           # spec.py _lock: journal cache + commits
                                # (reconciler rollback nests under 11/15)
    "server.admission": 20,     # admission.py gate condition
    "resilience.qos": 22,       # qos.py tenant quota table + header sketch
    "server.state_cond": 25,    # server.py _ServerState in-flight tracking
    "router.models": 30,        # router.py cached fleet model list
    "watchman.control": 35,     # control.py probe bookkeeping
    "watchman.errors": 36,      # watchman/server.py scrape-error table
    "router.rollout_state": 40, # rollout.py last-result state
    "router.workers": 45,       # workers.py supervisor slot table
    "router.placement": 50,     # placement.py ring + hot-tracking state
    "resilience.breaker_board": 55,  # breaker.py per-name board
    "resilience.breaker": 60,   # breaker.py one circuit's state
    "router.stitch": 52,        # router.py truncated-stitch pull ledger
    "resilience.quarantine": 62,  # quarantine.py ledger
    # a kernel library's first use builds or loads it (ops/_kernels.py
    # _LOAD_LOCK: resolve/fill of the loaded-library table) through the
    # kernel-library store, whose commit is a fault seam: so below the
    # fault plan, and never under the engine's program locks (a bucket
    # resolves its libraries before it takes engine.template)
    "kernels.load": 63,
    "resilience.faults": 64,    # faults.py injection plan
    "observability.incident": 65,  # incidents.py report ring + cooldowns
                                # (the correlator GATHERS lock-free; this
                                # only guards its in-memory state)
    "client.io": 66,            # client.py pooled-loop lifecycle
    "observability.telemetry": 67,  # telemetry.py warehouse index + segments
    "observability.slo": 68,    # slo.py evaluator history + breach state
    "observability.ledger": 69, # ledger.py control-event segments — a LEAF
                                # below every control-plane writer's lock
                                # (emit acquires nothing inside it)
    # -- engine data plane (these sit under everything above via
    # reload-time warmup and request-path scoring)
    "engine.bucket_cond": 70,   # _Bucket._cond leader/follower latch
    "engine.collector": 75,     # _Bucket._collector_lock handover
    "engine.template": 76,      # _Bucket._template_lock: one program call
                                # at a time per meta template (functional_
                                # call swaps its parameters); held across
                                # the enqueue, so across kernel launches
    "engine.spill": 77,         # _SpillScorer._lock: the same for one
                                # architecture's spill program
    "engine.depth": 78,         # _DepthGate._depth_cond: the dispatch
                                # depth's permit count (a leaf)
    "engine.hot": 80,           # _Bucket._hot_lock shard-mode hot cache
    "engine.mega": 82,          # _Bucket._mega_lock residency routing
    "engine.host_cache": 84,    # host_cache.py LRU dict + byte ledger
    "fleet.checkpoint": 85,     # build_fleet.py _SliceCheckpointer: its
                                # writer thread and deferred error (a leaf,
                                # taken by the build and the writer alone)
    # -- kernel libraries
    "compile_cache.store": 87,  # store.py per-store outcome counters
    "compile_cache.private": 88,  # store.py this process's library dir
    "kernels.launch": 89,       # ops/_kernels.py _LAUNCH_LOCK: launch counts
    # the process-global shard-mode lock (the reference's rank): taken
    # under engine.template for a cold dispatch's gather (and alone for a
    # hot promotion's), never across a kernel launch
    "engine.shard_dispatch": 90,
    "utils.http": 91,           # utils/http.py pooled idle connections
    # innermost: written from under nearly every lock above
    "observability.flightrec": 93,  # flightrec.py recent/slow/error rings
    "observability.spans": 94,  # spans.py one request's timeline
    # the traffic accountant's note() runs on the request path inside
    # scoring — nothing of the data plane may nest under it
    "observability.traffic": 95,  # traffic.py sketch + EWMA pending state
    "observability.registry": 96,  # registry.py name -> metric table
    "observability.series": 97,  # registry.py one metric's series values
}

# Request-hot-path locks: blocking calls under these stall live traffic
# (or the pipeline draining toward it). The admin locks — reload,
# rollout op, supervisor — and the kernel loader, whose first use builds
# or loads a library by design, deliberately block for seconds and are
# not listed.
HOT_LOCKS = frozenset(
    {
        "server.admission",
        "resilience.qos",
        "server.state_cond",
        "router.models",
        "router.placement",
        "router.stitch",
        "resilience.breaker_board",
        "resilience.breaker",
        "engine.bucket_cond",
        "engine.collector",
        "engine.template",
        "engine.spill",
        "engine.depth",
        "engine.hot",
        "engine.mega",
        "engine.host_cache",
        "engine.shard_dispatch",
        "kernels.launch",
        "utils.http",
        "observability.flightrec",
        "observability.spans",
        "observability.traffic",
        "observability.registry",
        "observability.series",
    }
)

# (file suffix, attribute name) -> lock name: how the static checker
# maps a ``with self._template_lock:`` (or module-global) expression in
# a given file onto the declared hierarchy. Attribute collisions across
# files (every module calls its lock ``_lock``) are resolved by the
# file suffix, which is why the mapping is keyed this way.
LOCK_ATTRS: Dict[Tuple[str, str], str] = {
    ("server/engine.py", "_SHARD_DISPATCH_LOCK"): "engine.shard_dispatch",
    ("server/engine.py", "_cond"): "engine.bucket_cond",
    ("server/engine.py", "_hot_lock"): "engine.hot",
    ("server/engine.py", "_mega_lock"): "engine.mega",
    ("server/engine.py", "_collector_lock"): "engine.collector",
    ("server/engine.py", "_template_lock"): "engine.template",
    ("server/engine.py", "_lock"): "engine.spill",
    ("server/engine.py", "_depth_cond"): "engine.depth",
    ("server/host_cache.py", "_lock"): "engine.host_cache",
    ("server/server.py", "_cond"): "server.state_cond",
    ("server/server.py", "_reload_lock"): "server.reload",
    ("resilience/admission.py", "_cond"): "server.admission",
    ("resilience/qos.py", "_lock"): "resilience.qos",
    ("resilience/breaker.py", "_lock"): "resilience.breaker",
    ("resilience/breaker.py", "_board_lock"): "resilience.breaker_board",
    ("resilience/quarantine.py", "_lock"): "resilience.quarantine",
    ("resilience/faults.py", "_lock"): "resilience.faults",
    ("router/router.py", "_models_lock"): "router.models",
    ("router/router.py", "_stitch_lock"): "router.stitch",
    ("observability/slo.py", "_lock"): "observability.slo",
    ("observability/telemetry.py", "_lock"): "observability.telemetry",
    ("observability/traffic.py", "_lock"): "observability.traffic",
    ("observability/ledger.py", "_lock"): "observability.ledger",
    ("observability/incidents.py", "_lock"): "observability.incident",
    ("observability/flightrec.py", "_lock"): "observability.flightrec",
    ("observability/spans.py", "_lock"): "observability.spans",
    ("observability/registry.py", "_lock"): "observability.series",
    ("observability/registry.py", "_table_lock"): "observability.registry",
    ("autopilot/controller.py", "_lock"): "autopilot.state",
    ("autopilot/elastic.py", "_lock"): "autopilot.elastic",
    ("router/rollout.py", "_op_lock"): "router.op",
    ("router/rollout.py", "_lock"): "router.rollout_state",
    ("router/placement.py", "_lock"): "router.placement",
    ("router/workers.py", "_lock"): "router.workers",
    ("watchman/control.py", "_lock"): "watchman.control",
    ("watchman/server.py", "_errors_lock"): "watchman.errors",
    ("client/client.py", "_io_lock"): "client.io",
    ("fleet/spec.py", "_lock"): "fleet.spec",
    ("fleet/reconciler.py", "_lock"): "fleet.reconcile",
    ("ops/_kernels.py", "_LAUNCH_LOCK"): "kernels.launch",
    ("ops/_kernels.py", "_LOAD_LOCK"): "kernels.load",
    ("compile_cache/store.py", "_lock"): "compile_cache.store",
    ("compile_cache/store.py", "_PRIVATE_LOCK"): "compile_cache.private",
    ("parallel/build_fleet.py", "_lock"): "fleet.checkpoint",
    ("parallel/shard_plan.py", "_PLAN_LOCK"): "parallel.shard_plan",
    ("utils/http.py", "_lock"): "utils.http",
}


# (file suffix, attribute/global name) -> lock name: the GUARDED-STATE
# declaration. Every mutable field listed here is OWNED by one declared
# lock — any read or write outside a ``with <its lock>:`` scope is a
# static finding (:mod:`.guarded_state`) and, under ``GORDO_LOCKCHECK=1``,
# a runtime violation at mutation (:func:`.lockcheck.assert_guard`).
# Keyed like LOCK_ATTRS: the attribute names collide across files
# (``_hot`` is a placement set here), the file suffix disambiguates.
# ``__init__``/``__new__`` are exempt (construction happens-before
# publication); deliberate lock-free reads carry
# ``# lint: allow-unguarded(<reason>)`` — the reason is mandatory.
GUARDED_FIELDS: Dict[Tuple[str, str], str] = {
    # engine bucket state: the shard-mode hot cache, the megabatch
    # residency slot table and the layout plan's pins
    ("server/engine.py", "_hot"): "engine.hot",
    ("server/engine.py", "_mega_slots"): "engine.mega",
    ("server/engine.py", "_mega_pinned"): "engine.mega",
    # host-RAM spill tier: the LRU dict, its byte ledger, and the
    # in-flight prefetch claims
    ("server/host_cache.py", "_entries"): "engine.host_cache",
    ("server/host_cache.py", "_bytes"): "engine.host_cache",
    ("server/host_cache.py", "_inflight"): "engine.host_cache",
    # server in-flight tracking: the drain/quiesce latch
    ("server/server.py", "_inflight"): "server.state_cond",
    # admission counters: occupancy, queue depth, closed marker
    ("resilience/admission.py", "_inflight"): "server.admission",
    ("resilience/admission.py", "_waiting"): "server.admission",
    ("resilience/admission.py", "_waiting_by"): "server.admission",
    ("resilience/admission.py", "_closed"): "server.admission",
    ("resilience/admission.py", "_shed_level"): "server.admission",
    ("resilience/admission.py", "_class_sheds"): "server.admission",
    ("resilience/admission.py", "_releases"): "server.admission",
    # tenant quota table: raw-header sketch fed under the qos lock
    ("resilience/qos.py", "_header_sketch"): "resilience.qos",
    # fault-injection plan (module global, not an attribute)
    ("resilience/faults.py", "_rules"): "resilience.faults",
    # router: cached fleet model list + placement ring/rate state +
    # supervisor slot table
    ("router/router.py", "_models_cache"): "router.models",
    ("router/placement.py", "ring"): "router.placement",
    ("router/placement.py", "_rates"): "router.placement",
    ("router/placement.py", "_rotation"): "router.placement",
    ("router/placement.py", "_hot"): "router.placement",
    ("router/placement.py", "_worker_shards"): "router.placement",
    # the process-wide serving-mesh layout-plan cache
    ("parallel/shard_plan.py", "_PLAN_CACHE"): "parallel.shard_plan",
    ("router/workers.py", "_workers"): "router.workers",
    ("router/workers.py", "_respawns"): "router.workers",
    # SLO burn-rate history + breach edge state
    ("observability/slo.py", "_history"): "observability.slo",
    ("observability/slo.py", "_breached"): "observability.slo",
    ("observability/slo.py", "_breach_counts"): "observability.slo",
    # autopilot actuator state + decision journal
    ("autopilot/controller.py", "_state"): "autopilot.state",
    ("autopilot/controller.py", "_decisions"): "autopilot.state",
    # telemetry warehouse query index / byte ledger + the traffic
    # accountant's between-ticks pending counts and EWMA table
    ("observability/telemetry.py", "_index"): "observability.telemetry",
    ("observability/traffic.py", "_pending"): "observability.traffic",
    ("observability/traffic.py", "_rates"): "observability.traffic",
    # control ledger segment index + incident report ring
    ("observability/ledger.py", "_index"): "observability.ledger",
    ("observability/incidents.py", "_reports"): "observability.incident",
    # fleet spec journal cache + reconciler repair ring / WAL step map
    ("fleet/spec.py", "_records"): "fleet.spec",
    ("fleet/reconciler.py", "_ring"): "fleet.reconcile",
    ("fleet/reconciler.py", "_steps"): "fleet.reconcile",
    # the slice checkpointer's writer thread and its deferred error
    ("parallel/build_fleet.py", "_thread"): "fleet.checkpoint",
    ("parallel/build_fleet.py", "_error"): "fleet.checkpoint",
}


def rank_of(name: str) -> int:
    return LOCK_RANKS[name]


def may_nest(outer: str, inner: str) -> bool:
    """Whether acquiring ``inner`` while holding ``outer`` respects the
    declared hierarchy (strictly increasing rank)."""
    return LOCK_RANKS[inner] > LOCK_RANKS[outer]
