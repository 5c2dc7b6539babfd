"""THE port's ``GORDO_*`` env-knob registry: one declaration per knob.

Every ``os.environ`` / ``os.getenv`` / argparse default read of a
``GORDO_*`` name anywhere in the port's tree must have an entry here —
the :mod:`.knob_registry` checker enforces it — and the knob table of
README.md's port section is GENERATED from this module (``python -m
gordo_components_tpu_torch.analysis --write-knob-table``), so the docs
cannot drift from the code. A knob keeps the reference's name, parser
and meaning; its default is the one the port's code has.

``default`` is the human-readable default (including "core-aware"
formulas), ``parser`` the accepted value shape. Keep docs to one line:
they become table cells.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class Knob:
    name: str
    default: str
    parser: str      # int | float | str | bool | path | spec
    doc: str         # one line; becomes the README table cell
    component: str   # serving | engine | build | store | observability |
                     # resilience | autopilot | fleet | layout | test


def _knob(name, default, parser, doc, component) -> Tuple[str, Knob]:
    return name, Knob(name, default, parser, doc, component)


KNOBS: Dict[str, Knob] = dict(
    [
        # -- autopilot -----------------------------------------------------
        _knob("GORDO_AUTOPILOT", "unset", "bool",
              "closed-loop controller: `1` enables at boot, unset boots "
              "disabled but runtime-enableable (`POST /autopilot/enable`), "
              "explicit `0` is the hard kill switch (no controller at all)",
              "autopilot"),
        _knob("GORDO_AUTOPILOT_BACKOFF", "0.5", "float",
              "AIMD multiplicative-decrease factor on a downward decision "
              "(never less than -1 per step)",
              "autopilot"),
        _knob("GORDO_AUTOPILOT_BURN_HIGH", "1.0", "float",
              "fast-window burn rate at/above which the controller backs "
              "actuators off (multiplicative decrease)",
              "autopilot"),
        _knob("GORDO_AUTOPILOT_BURN_LOW", "0.25", "float",
              "fast-window burn rate at/below which the controller may "
              "probe upward (additive increase)",
              "autopilot"),
        _knob("GORDO_AUTOPILOT_CONFIRM", "2", "int",
              "hysteresis: consecutive ticks a direction must persist "
              "before the controller acts on it",
              "autopilot"),
        _knob("GORDO_AUTOPILOT_COOLDOWN", "30", "float",
              "per-actuator seconds between applied adaptations (the AIMD "
              "settling time)",
              "autopilot"),
        _knob("GORDO_AUTOPILOT_DEPTH_BOUNDS", "1:8", "spec",
              "`min:max` hard bounds for live dispatch-depth tuning (the "
              "GORDO_DISPATCH_DEPTH actuator)",
              "autopilot"),
        _knob("GORDO_AUTOPILOT_FILL_BOUNDS", "0:4000", "spec",
              "`min:max` hard bounds (µs) for live fill-window tuning (the "
              "GORDO_FILL_WINDOW_US actuator)",
              "autopilot"),
        _knob("GORDO_AUTOPILOT_IDLE_RPS", "1.0", "float",
              "observed fleet request rate below which (with zero burn) "
              "sustained idle may retire a worker down to the floor",
              "autopilot"),
        _knob("GORDO_AUTOPILOT_INFLIGHT_BOUNDS", "8:256", "spec",
              "`min:max` hard bounds for live admission tuning (the "
              "GORDO_MAX_INFLIGHT actuator)",
              "autopilot"),
        _knob("GORDO_AUTOPILOT_INTERVAL", "5", "float",
              "min seconds between scrape-driven autopilot evaluation ticks "
              "(`/metrics` and `/autopilot` reads piggyback them)",
              "autopilot"),
        _knob("GORDO_AUTOPILOT_RESIDENCY_BOUNDS", "16:1024", "spec",
              "`min:max` hard bounds for live megabatch-residency tuning; "
              "on one card every machine is resident, so the actuator reads "
              "not applicable and never acts",
              "autopilot"),
        _knob("GORDO_AUTOPILOT_SCALE_TICKS", "3", "int",
              "elastic hysteresis: consecutive ticks of sustained burn / "
              "idle before a worker is spawned or retired",
              "autopilot"),
        _knob("GORDO_AUTOPILOT_SHED_BOUNDS", "0:8", "spec",
              "`min:max` rungs for the shed-ladder actuator: sustained SLO "
              "burn progressively tightens the BULK class's admission "
              "share, relaxing on recovery",
              "autopilot"),
        _knob("GORDO_AUTOPILOT_STEP", "0.5", "float",
              "AIMD additive-increase fraction of the current value (min "
              "+1) on an upward decision",
              "autopilot"),
        _knob("GORDO_AUTOPILOT_WORKER_BOUNDS", "1:8", "spec",
              "`floor:ceiling` for the elastic worker count (the router's "
              "spawn/retire actuator)",
              "autopilot"),
        # -- build ---------------------------------------------------------
        _knob("GORDO_BUILD_FETCH_BACKOFF", "1.0", "float",
              "fleet build: base seconds between data-fetch retries "
              "(exponential)",
              "build"),
        _knob("GORDO_BUILD_FETCH_RETRIES", "2", "int",
              "fleet build: per-machine data-fetch retries before "
              "zero-weight isolation",
              "build"),
        _knob("GORDO_COORDINATOR", "unset", "str",
              "`fleet-build` of several ranks: the gloo group's coordinator "
              "`host:port`, where rank 0 listens (`--coordinator-address`)",
              "build"),
        _knob("GORDO_NUM_PROCESSES", "unset", "int",
              "`fleet-build` of several ranks: the group's size "
              "(`--num-processes`)",
              "build"),
        _knob("GORDO_PROCESS_ID", "unset", "int",
              "`fleet-build` of several ranks: this process's rank "
              "(`--process-id`)",
              "build"),
        _knob("GORDO_SLICE_TIMEOUT_S", "unset", "float",
              "`fleet-build` of several ranks: seconds a slice may take before "
              "the watchdog exits the rank with 75 (retryable); unset, none",
              "build"),
        _knob("GORDO_COMPILE_CACHE", "unset", "path",
              "`build` / `fleet-build`: the kernel-library store a fit "
              "resolves its flash libraries through "
              "(`--compile-cache-dir`); `off` = the package's build "
              "directory",
              "build"),
        _knob("GORDO_PRECISION_DEFAULT", "f32", "str",
              "build-time default rung on the serving precision ladder "
              "(`f32`/`bf16`/`int8`); `--precision` on `build` and "
              "`fleet-build` overrides, `--precision-map` pins per machine",
              "build"),
        # -- engine --------------------------------------------------------
        _knob("GORDO_DISPATCH_DEPTH", "2 (≥4 CPUs) / 1", "int",
              "bounded in-flight device dispatches per bucket; 1 = serial "
              "bit-identical comparison mode",
              "engine"),
        _knob("GORDO_MEGABATCH", "1", "bool",
              "cross-machine fused dispatch (replicated engines only; "
              "`0`/`off` disables, `--no-megabatch` on `run-server`)",
              "engine"),
        _knob("GORDO_FILL_WINDOW_US", "250 µs (≥4 CPUs) / 1000 µs", "int",
              "bounded fill window a megabatching leader holds open when it "
              "observes concurrency; `0` = drain-only fusion (the "
              "`fill_window_us` keyword of `ServingEngine` overrides it)",
              "engine"),
        _knob("GORDO_MEGABATCH_RESIDENCY", "128", "int",
              "machines per bucket resident in the megabatch tier; buckets "
              "at/under the cap are fully resident from boot, in larger ones "
              "a machine is admitted after 2 cold hits; `0` disables "
              "megabatching",
              "engine"),
        _knob("GORDO_SERVE_HOT_CACHE", "16", "int",
              "shard mode (`run-server --shard-fleet`): machines per bucket "
              "keeping a hot copy on the dispatch device (skips the gather "
              "and the shard lock); 0 disables",
              "engine"),
        _knob("GORDO_HOST_CACHE_MB", "256", "int",
              "host-RAM spill tier: megabytes of deserialized pre-stacked "
              "host arrays cached between device residency and the model "
              "store; `0` disables (every lazy request pays the store path)",
              "engine"),
        # -- fleet ---------------------------------------------------------
        _knob("GORDO_FLEET", "unset", "bool",
              "declarative fleet reconciler: unset/`1` constructs it (inert "
              "until a spec is committed via `/fleet/apply`), explicit `0` "
              "is the hard kill switch (no reconciler at all; `/fleet` "
              "answers hard_off)",
              "fleet"),
        _knob("GORDO_FLEET_COOLDOWN", "30", "float",
              "seconds a divergence class rests after a repair (seeded from "
              "the reconcile WAL on restart); the oscillation guard's hold "
              "window is 4× this",
              "fleet"),
        _knob("GORDO_FLEET_INTERVAL", "10", "float",
              "min seconds between scrape-driven reconcile ticks "
              "(`/metrics` and `/fleet` reads piggyback them)",
              "fleet"),
        _knob("GORDO_FLEET_REPAIR_BUDGET", "2", "int",
              "max repairs applied per reconcile tick — a degraded fleet is "
              "nudged toward spec, never stormed; the rest journal "
              "`deferred`",
              "fleet"),
        # -- layout --------------------------------------------------------
        _knob("GORDO_LAYOUT_DRIFT", "0.35", "float",
              "total-variation distance between the plan's recorded traffic "
              "shares and fresh telemetry above which the plan counts as "
              "stale (0..1)",
              "layout"),
        _knob("GORDO_LAYOUT_HORIZON", "10m", "str",
              "rate horizon the reconciler's layout staleness check and "
              "re-derive compile read telemetry over (seconds or "
              "`1m`/`10m`/`1h` forms; snaps to the nearest warehouse EWMA "
              "horizon)",
              "layout"),
        _knob("GORDO_LAYOUT_MAX_AGE", "900", "float",
              "seconds before a committed layout plan counts as stale on "
              "age alone and the reconciler re-derives it",
              "layout"),
        _knob("GORDO_LAYOUT_PARITY_BUDGET", "0", "float",
              "traffic-weighted parity budget `compile_plan` may spend on "
              "precision downgrades when the caller passes none (0 disables "
              "planned downgrades)",
              "layout"),
        _knob("GORDO_LAYOUT_REDERIVE", "1", "bool",
              "`0` stops the reconciler from re-deriving stale layout plans "
              "(it keeps converging on the committed one; `gordo layout "
              "apply` stays the only author)",
              "layout"),
        # -- observability -------------------------------------------------
        _knob("GORDO_FLIGHTREC", "1", "bool",
              "always-on flight recorder; `0` disables recording "
              "(perf-comparison escape hatch)",
              "observability"),
        _knob("GORDO_FLIGHTREC_ERROR_KEEP", "64", "int",
              "flight recorder: error-request ring size",
              "observability"),
        _knob("GORDO_FLIGHTREC_KEEP", "256", "int",
              "flight recorder: recent-request ring size",
              "observability"),
        _knob("GORDO_FLIGHTREC_SLOW_KEEP", "32", "int",
              "flight recorder: slowest-since-boot reservoir size",
              "observability"),
        _knob("GORDO_INCIDENT_COOLDOWN", "120", "float",
              "min seconds between incident reports for the same objective "
              "(breach flapping folds into one incident)",
              "observability"),
        _knob("GORDO_INCIDENT_KEEP", "32", "int",
              "incident reports retained (ring + on-disk files); oldest are "
              "dropped past it",
              "observability"),
        _knob("GORDO_INCIDENT_LOOKBACK", "600", "float",
              "incident correlator: seconds of ledger history and warehouse "
              "deltas gathered into a breach report",
              "observability"),
        _knob("GORDO_LEDGER", "1", "bool",
              "control ledger: `0` disables control-event recording (every "
              "writer's emit becomes a no-op)",
              "observability"),
        _knob("GORDO_LEDGER_DIR", "unset", "path",
              "ledger segment root; each process appends under its own role "
              "subdir (`worker-<id>`/`router`); unset = "
              "`<models_root>/.telemetry/ledger-<role>` (in-memory only "
              "when no models root either)",
              "observability"),
        _knob("GORDO_LEDGER_MB", "16", "int",
              "hard byte budget for the on-disk control ledger in MiB; "
              "whole oldest segments are deleted to stay under it",
              "observability"),
        _knob("GORDO_LEDGER_SEGMENT_KB", "128", "int",
              "ledger segment rotation threshold in KiB",
              "observability"),
        _knob("GORDO_LOG_FORMAT", "text", "str",
              "`text` or `json` (one JSON object per record with trace/span "
              "ids; `--log-format`)",
              "observability"),
        _knob("GORDO_LOG_LEVEL", "INFO", "str",
              "root log level (`--log-level`)",
              "observability"),
        _knob("GORDO_METRICS_MACHINE_CARDINALITY", "64", "int",
              "machine-labeled metric families render at most this many "
              "distinct machines per family (top-K by traffic) plus one "
              "`machine=\"other\"` aggregate, so exposition size is bounded "
              "at any fleet size; `0` disables the bound",
              "observability"),
        _knob("GORDO_ROUTER_AGGREGATE", "1", "bool",
              "router scrape-of-scrapes: `0` makes `/metrics?aggregate=1` "
              "serve the router registry only (no worker fan-out scrape)",
              "observability"),
        _knob("GORDO_SLO", "1", "bool",
              "SLO engine: `0` disables evaluation (`/slo` answers "
              "disabled, no `gordo_slo_*` series)",
              "observability"),
        _knob("GORDO_SLO_AVAILABILITY_TARGET", "0.999", "float",
              "availability objective: fraction of requests that must not "
              "error (5xx / unroutable)",
              "observability"),
        _knob("GORDO_SLO_EVAL_INTERVAL", "10", "float",
              "min seconds between scrape-driven SLO evaluation ticks "
              "(`/metrics` and `/slo` reads piggyback evaluation)",
              "observability"),
        _knob("GORDO_SLO_FAST_BURN", "14.4", "float",
              "burn-rate threshold whose crossing on the fast window fires "
              "a breach event",
              "observability"),
        _knob("GORDO_SLO_FAST_WINDOW", "300", "float",
              "fast burn-rate window seconds (the page-now signal)",
              "observability"),
        _knob("GORDO_SLO_LATENCY_MS", "250", "float",
              "latency objective threshold: scoring/route requests should "
              "finish under this many milliseconds",
              "observability"),
        _knob("GORDO_SLO_LATENCY_TARGET", "0.99", "float",
              "latency objective: fraction of requests that must meet the "
              "threshold",
              "observability"),
        _knob("GORDO_SLO_SLOW_BURN", "6.0", "float",
              "burn-rate threshold whose crossing on the slow window fires "
              "a breach event",
              "observability"),
        _knob("GORDO_SLO_SLOW_WINDOW", "3600", "float",
              "slow burn-rate window seconds (the sustained-burn signal)",
              "observability"),
        _knob("GORDO_TELEMETRY", "1", "bool",
              "fleet telemetry warehouse: `0` disables the snapshotter, "
              "traffic accounting, and `/telemetry` (answers disabled)",
              "observability"),
        _knob("GORDO_TELEMETRY_DIR", "unset", "path",
              "warehouse segment directory; unset = "
              "`<models_root>/.telemetry/worker-<id>` (in-memory only when "
              "no models root either)",
              "observability"),
        _knob("GORDO_TELEMETRY_INTERVAL", "15", "float",
              "min seconds between scrape-driven warehouse snapshot ticks "
              "(`/metrics` and `/telemetry` reads piggyback)",
              "observability"),
        _knob("GORDO_TELEMETRY_MB", "64", "int",
              "hard byte budget for the on-disk warehouse in MiB; whole "
              "oldest segments are deleted to stay under it",
              "observability"),
        _knob("GORDO_TELEMETRY_SEGMENT_KB", "256", "int",
              "warehouse segment rotation threshold in KiB (smaller = "
              "finer-grained budget trims, more files)",
              "observability"),
        _knob("GORDO_TELEMETRY_TOPK", "512", "int",
              "Space-Saving sketch capacity: how many heavy-hitter machines "
              "the traffic accountant tracks exactly-ish (error bounded by "
              "total/capacity)",
              "observability"),
        _knob("GORDO_TIMELINE_MAX_BYTES", "8192", "int",
              "trace stitching: size cap for the worker's "
              "`X-Gordo-Timeline` response header (past it the router pulls "
              "the timeline from the worker instead)",
              "observability"),
        _knob("GORDO_TRACE_DIR", "unset", "path",
              "torch.profiler Chrome trace of a build (`--trace-dir` on "
              "`build` / `fleet-build`)",
              "observability"),
        _knob("GORDO_DEBUG_NANS", "0", "bool",
              "the numeric sanitizer: every op's output checked, "
              "FloatingPointError at the first NaN (diagnostics only; "
              "`--debug-nans`)", "observability"),
        # -- resilience ----------------------------------------------------
        _knob("GORDO_FAULTS", "unset", "spec",
              "fault-injection plan (`point:target:kind[:arg]`, "
              "comma-separated) powering the chaos suite; `--faults` on "
              "`run-server`",
              "resilience"),
        # -- serving -------------------------------------------------------
        _knob("GORDO_BOOT_EAGER", "0", "int",
              "lazy fleet boot: machines (index order) materialized eagerly "
              "at boot to warm the common architecture's programs; the rest "
              "stay behind the spill tier",
              "serving"),
        _knob("GORDO_COMPILE_CACHE_STORE", "<models_root>/.compile-cache/torch-cuda", "path",
              "serving-side kernel-library store (checksummed flash "
              "libraries a boot loads with no `nvcc`); `off` disables "
              "(`--compile-cache-store` on `run-server`)",
              "serving"),
        _knob("GORDO_DRAIN_TIMEOUT", "10", "float",
              "graceful-shutdown budget: seconds SIGTERM waits for "
              "in-flight requests before stopping the listener",
              "serving"),
        _knob("GORDO_LAZY_BOOT", "0", "bool",
              "lazy fleet boot: boot from the `FLEET_INDEX.json` sidecar — "
              "O(index read) instead of O(load the fleet); non-eager "
              "machines serve through the host-RAM spill tier with "
              "first-touch verification (`--lazy-boot` on `run-server`)",
              "serving"),
        _knob("GORDO_MAX_INFLIGHT", "64", "int",
              "admission gate: concurrent admitted requests "
              "(`--max-inflight` on `run-server`)",
              "serving"),
        _knob("GORDO_MAX_QUEUE", "32", "int",
              "admission gate: waiters allowed behind a full gate "
              "(micro-burst absorption)",
              "serving"),
        _knob("GORDO_QUEUE_TIMEOUT", "1.0", "float",
              "seconds a waiter queues for admission before shedding 503",
              "serving"),
        _knob("GORDO_MESH_SHARDS", "0", "int",
              "fleet-sharded serving mesh: total shard count the stacked "
              "fleet partitions across by ring position; 0 = single-host "
              "serving (`--mesh-shards` on `run-server` / "
              "`run-fleet-server`)", "serving"),
        _knob("GORDO_MESH_SHARD", "worker-id mod shards", "int",
              "mesh serving: THIS process's shard id (0-based); each "
              "shard stacks only its owned machines and serves the rest "
              "through the spill fallback rung (`--mesh-shard` on "
              "`run-server`)", "serving"),
        _knob("GORDO_MESH_MIN_SHARD_MACHINES", "2×shards", "int",
              "mesh serving's declared layout policy: fleets smaller "
              "than this stay replicated on every shard (the split would "
              "cost more than it frees); larger fleets shard by ring "
              "position", "serving"),
        _knob("GORDO_QOS_DEFAULT_CLASS", "standard", "str",
              "priority class for bare requests and undeclared tenants "
              "(`interactive`/`standard`/`bulk`)",
              "serving"),
        _knob("GORDO_QOS_WEIGHTS", "interactive=8,standard=4,bulk=1", "spec",
              "deficit-weighted fair-share ratios a bucket's fill window "
              "drains classes by (scores stay byte-identical; only "
              "intra-window ORDER changes)",
              "serving"),
        _knob("GORDO_TENANTS", "unset", "spec",
              "multi-tenant QoS table: `name:class[:rate[:burst[:key]]]` "
              "entries separated by `;` — class "
              "`interactive`/`standard`/`bulk`, rate in requests/s (0 = "
              "unmetered token bucket), key an optional API key; requests "
              "pick a tenant via `X-Gordo-Tenant`, unknown names fold into "
              "`default` (`--tenants` on `run-server` / `run-fleet-server`)",
              "serving"),
        _knob("GORDO_WORKER_ID", "unset", "int",
              "horizontal tier: this worker's slot id (stamped on responses "
              "as `X-Gordo-Worker`; set by the router supervisor)",
              "serving"),
        # -- store ---------------------------------------------------------
        _knob("GORDO_MAX_ARTIFACT_BYTES", "2 GiB", "int",
              "bounded artifact loads: max decompressed tar bytes a model "
              "load will extract",
              "store"),
        _knob("GORDO_STORE_FSYNC", "1", "bool",
              "`0` disables commit-path fsyncs (durability escape hatch for "
              "bulk synthetic-fleet generation — atomicity is kept, "
              "power-cut durability is not)",
              "store"),
        _knob("GORDO_STORE_KEEP_GENERATIONS", "3", "int",
              "generations kept per machine after a commit prunes old ones "
              "(always ≥ 2 so one rollback step survives)",
              "store"),
        # -- test ----------------------------------------------------------
        _knob("GORDO_LOCKCHECK", "0", "bool",
              "runtime lock-order witness of the port: its named locks "
              "record real acquisition orders, and "
              "`lockcheck.violations()`/`report()` name any order the "
              "declared hierarchy (analysis/locks.py) forbids; read at "
              "import",
              "test"),
        _knob("GORDO_PARITY_RTOL_BF16", "0.02", "float",
              "bf16 parity budget: max |bf16−f32| of total anomaly scores, "
              "normalized to the mean f32 score (`precision.parity_rtol`)",
              "test"),
        _knob("GORDO_PARITY_RTOL_INT8", "0.08", "float",
              "int8 parity budget: same ruler as the bf16 budget, looser — "
              "int8 trades more accuracy for 4x weight compression",
              "test"),
    ]
)


def get(name: str) -> Optional[Knob]:
    return KNOBS.get(name)


def render_markdown_table(component: Optional[str] = None) -> str:
    """The README's port knob table (all components interleaved, sorted
    by component then name) — regenerate with
    ``python -m gordo_components_tpu_torch.analysis --write-knob-table``."""
    rows = [
        knob for knob in KNOBS.values()
        if component is None or knob.component == component
    ]
    rows.sort(key=lambda knob: (knob.component, knob.name))
    lines = [
        "| knob | default | meaning |",
        "|---|---|---|",
    ]
    for knob in rows:
        lines.append(f"| `{knob.name}` | `{knob.default}` | {knob.doc} |")
    return "\n".join(lines)
