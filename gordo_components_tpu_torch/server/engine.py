"""Stacked multi-machine serving engine (port of
``gordo_components_tpu/server/engine.py``: the knobs at 273-349,
``ScoreResult`` … ``_make_machine_score`` at 210-253 and 352-523, the
pipeline at 611-748, ``_Bucket`` at 750-2499 and ``ServingEngine`` at
2501-3262 and its metrics at 95-190, with the request seams: span
timelines, the weighted-fair drain and the ``engine-dispatch`` fault
point; the control loops' seams: traffic notes, ``cost_ledger``, live
tuning; the host-RAM spill tier at 526-608, 2560-2584, 2820-2956 and
3039-3115, with the fleet-sharded mesh's accounting at 168-181,
2538-2559, 2698-2700, 2967-2969, 3050-3070 and 3197-3208; the compile
cache's counterpart at 1214-1296 and 3192: the kernel libraries each
bucket and each lazy machine launches, resolved through a store before
they first run; the megabatch residency tier at 894-933, 1098-1212,
1556-1646, 2127-2278 and 2295-2392; and the host-sharded capacity mode
with its hot cache at 846-893, 1060-1107, 1298-1335, 1679-1788,
1871-2070 and 2394-2499).

Every machine that shares an architecture (the reference's signature:
config, loss, widths, lookback, lookahead and precision) is stacked into
one tree on the device: parameters, the three scaler affines and the
target columns, each with a leading machine axis. The stack is built on
the host and placed on the device once; no per-machine module lives
there. Scoring — scale → window → forward → inverse-scale → residual on
the target columns → error-scale → L2 — is ONE function of (machine tree,
rows), ``_make_machine_score``, mapped over a batch of requests with
``torch.func.vmap`` (a lone request runs it unbatched); the forward runs
by ``torch.func.functional_call`` on one template module per bucket that
holds no weights (its parameters are on the ``meta`` device). So
concurrent requests for DIFFERENT machines of one bucket score in one
dispatch: each layer is one batched kernel for all of them, and a PatchTST
bucket's flash kernel runs once per layer at BH = k·BH
(``ops/flash_attention.py``'s vmap rule).

Concurrency, as the reference: whichever request thread reaches a bucket
first is the leader. It drains everything that queued while the device
was busy into dispatches of up to ``max_batch`` requests per padded row
count, and only ENQUEUES them — PyTorch returns before the card finishes,
as JAX does. The outputs' copy to pinned host memory is enqueued right
behind the work and a CUDA event behind that; the fetch stage (a
per-bucket collector thread when there is more work to overlap with,
inline otherwise) waits on the event and fans results out. In-flight
depth is bounded (``GORDO_DISPATCH_DEPTH``). A bounded fill window
(``GORDO_FILL_WINDOW_US``; megabatching engines only) lets a leader that
sees concurrency collect submits across machines before its first drain;
an idle request never waits. A dispatch of several requests that fails, at
enqueue or at fetch, on any path, is rescored one request per cold
dispatch, so a bad machine or an out-of-memory batch fails only its own
waiters. Every dispatch, stack upload and fetch runs on the device's
current stream.

Three paths, one closure (``_Bucket._program``, which gathers k machines
from a stack and scores them): the **cold** and the **mega** path gather
by machine index from the bucket's stack; the **hot** path (shard mode)
scores one machine's own copy. The mega path (replicated engines,
``megabatch=``, default ``GORDO_MEGABATCH``) is the reference's megabatch
residency tier: a bucket of at most ``megabatch_residency`` machines
(default ``GORDO_MEGABATCH_RESIDENCY``, 128) is fully resident and every
batch routes mega. A larger bucket starts with no resident machine: a
machine is admitted on its second cold hit, an LRU evicts past the cap
unless its victim served within the freshness window or is pinned by a
layout plan (``pin_residency``), and a machine whose fused dispatch failed
is demoted and re-admitted after ``2·8^demotions`` hits. A batch routes
mega only when every machine in it is resident. The reference keeps a
capped copy of the resident machines on the device, since XLA compiles a
program per stack shape; here the whole stack is on the device already and
an eager program compiles nothing, so a slot is the machine's own row of
the stack and residency is bookkeeping: the admissions, the counts and the
live cap (``set_mega_cap``) are the reference's, and the answers are the
cold path's bits.

Shard mode (``mesh=``, :func:`~..parallel.mesh.fleet_mesh`, the host-sharded
capacity mode for a fleet whose stack does not fit one device): each
bucket's stack is built on the host, padded to a multiple of the devices
by repeating entry 0 (never dispatched) and split into one contiguous
chunk per device; it is never whole on one device. The cold program turns
each machine index into (chunk, row), gathers the machines' slices on their
chunks' devices and brings them to the dispatch device (the mesh's first),
under the process-wide shard lock (``engine.shard_dispatch``, which spans
engine generations); megabatching is off. The hot cache
(``hot_cap``, default ``GORDO_SERVE_HOT_CACHE``, 16) keeps a copy of a
machine's slice on the dispatch device from its second cold hit on, so a
pure batch of it skips the gather and the shard lock; the promotion runs
on the fetch stage after the waiters are released, with the residency
tier's backoff and freshness rules, and a hot dispatch that fails (at
enqueue or at fetch) demotes its machine and is rescored cold. Answers
equal the single-device engine's bit for bit for the same batch.

Rows are padded to a power of two of at least ``min_rows_bucket`` (the
reference's shape rule, and the key by which requests fuse), but a
dispatch computes only the rows its longest real request holds (see
``_Bucket._batch_inputs``). Requests longer than ``max_rows_dispatch``
score in overlapping chunks (``ServingEngine._chunked_score``).

Precision rungs (``precision.py``): ``f32``; ``bf16`` — weights stored in
bfloat16 and windows rounded to bfloat16, the forward computed in the
architecture's ``compute_dtype`` (flax promotes bf16 weights the same way)
and everything around it in float32; ``int8`` — weights quantized per flax
leaf (the artifact's ``quant_int8.npz`` when it matches the parameters,
else quantized on the fly with the same formula), stacked as int8 on the
device with their float32 scales beside them, and dequantized inside the
program on every dispatch (``q.float() * scale``, the reference's multiply)
before the forward runs in float32.

Every request checks its deadline (``resilience/deadline.py``) before it
is queued and before each chunk, so expired work never reaches the
device. Dispatches, requests per rung and megabatch events record into
the port's metrics registry under the reference's series names. Each
request (not each chunk or dispatch) is noted once in the traffic
accountant (``observability/traffic.py``) under its bucket's
``shape_key`` and rung, and each bucket sums the seconds its dispatches
took from enqueue to fetched outputs: ``cost_ledger`` reports them per rung
beside the stacked bytes, for the telemetry warehouse.

The spill tier (``lazy=``): a machine registered lazily, ``{name:
loader}``, is not stacked and holds no device bytes. Its first request
pays the store path: the loader verifies and deserialises the artifact,
the engine lifts it into the machine's host tree (pinned once on a CUDA
engine) and caches that bundle in the byte-bounded
:class:`~.host_cache.HostTierCache` (``GORDO_HOST_CACHE_MB``, default 256;
0 disables it). Every request of it copies the tree to the device and
runs the bucket's own closure unbatched through a per-architecture
:class:`_SpillScorer`, as a bucket runs a lone request, so a spilled
answer equals the same machine's lone eager answer to the bit. A lazy
machine the engine cannot lift raises :class:`SpillNotLiftable`, and one
loaded eagerly lands in :attr:`ServingEngine.skipped`; the server scores
both on the host path (``model.anomaly``), for which the engine places
their estimators on its device. ``prefetch`` queues background loads.

Request seams, as the reference's: each request's priority class
(``resilience/qos.py``) and span context (``observability/spans.py``) are
captured when it is submitted, since the leader and the collector that
serve it run on other threads. The leader orders each row bucket's
pending requests by ``qos.weighted_interleave`` before slicing it into
dispatches, so a bulk flood fills the tail of a drain, not every slot of
its first dispatch; scores are per request under ``vmap``, so the order
changes no byte. The stages ``queue_wait``, ``megabatch``, ``dispatch``,
``device_execute`` and ``fetch`` are recorded into each request's own
timeline from host clocks read around waits that exist anyway: no
synchronize, no event and no device work is added for them. The
collector binds the context of a dispatch's first request, so its log
records carry that trace id. ``ServingEngine.anomaly`` stages its
pre-dispatch seams (deadline, ``faults.inject`` and ``faults.corrupt`` at
``engine-dispatch``) as ``dispatch``.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import queue
import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import precision as precision_mod
from ..analysis import lockcheck
from ..models.analysis import analyze_model
from ..models.convert import quantized_params_from_flax
from ..models.transformers import MinMaxScaler, StandardScaler
from ..observability import spans
from ..observability import traffic as traffic_accounting
from ..observability.registry import REGISTRY
from ..ops import _kernels, windowing
from ..parallel.mesh import pad_to_multiple
from ..ops.scaling import ScalerParams
from ..resilience import deadline, faults, qos
from ..serializer.persistence import estimators
from ..utils.backend import DeviceLike, nan_guard, resolve_device
from .host_cache import HostTierCache

logger = logging.getLogger(__name__)

# -- engine telemetry (the reference's series; the process-wide registry,
# so a scrape survives a reload's engine swap)
_M_DISPATCH_SECONDS = REGISTRY.histogram(
    "gordo_engine_dispatch_seconds",
    "Compile-free enqueue-to-fetch-complete latency of one device "
    "dispatch, by path (cold=stacked gather, hot=unsharded hot-cache "
    "copy); under pipelined dispatch this includes any in-flight queue "
    "wait ahead of the fetch",
    labels=("path",),
)
_M_DISPATCH_BATCH = REGISTRY.histogram(
    "gordo_engine_dispatch_batch_size",
    "Requests coalesced into one device dispatch (micro-batching)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128),
)
_M_REQUESTS = REGISTRY.counter(
    "gordo_engine_requests_total",
    "Requests scored on device, by dispatch path (cold = gathered from the "
    "bucket's stack, mega = the resident stack, hot = a shard-mode hot "
    "copy, spill = the host-RAM spill tier)",
    labels=("path",),
)
_M_HOT_EVENTS = REGISTRY.counter(
    "gordo_engine_hot_cache_events_total",
    "Hot-machine cache lifecycle: promote, evict, demote (dispatch "
    "failure), backoff_defer (re-promotion blocked by demotion backoff)",
    labels=("event",),
)
_M_MEGA_BATCH = REGISTRY.histogram(
    "gordo_engine_megabatch_fused_requests",
    "Requests fused into one cross-machine megabatch dispatch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128),
)
_M_MEGA_MACHINES = REGISTRY.histogram(
    "gordo_engine_megabatch_fused_machines",
    "DISTINCT machines fused into one megabatch dispatch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128),
)
_M_FILL_TRIGGER = REGISTRY.counter(
    "gordo_engine_fill_window_total",
    "Fill-window outcomes per leadership: size (a full max_batch was "
    "pending before the window elapsed), timeout (window elapsed)",
    labels=("trigger",),
)
_M_FILL_OCCUPANCY = REGISTRY.histogram(
    "gordo_engine_fill_window_occupancy",
    "Pending requests at fill-window close, as a fraction of max_batch",
    buckets=(0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
)
_M_PRECISION = REGISTRY.counter(
    "gordo_engine_precision_total",
    "Requests scored on device by the serving bucket's numeric precision "
    "(f32 / bf16 / int8)",
    labels=("precision",),
)
_M_MEGA_EVENTS = REGISTRY.counter(
    "gordo_engine_megabatch_events_total",
    "Megabatch residency and repair lifecycle: promote, evict, demote, "
    "backoff_defer (re-promotion blocked by demotion backoff), "
    "residency_resize, fallback_cold (enqueue failure rescored one request "
    "per cold dispatch), retry_isolated (fetch failure rescored one request "
    "at a time)",
    labels=("event",),
)
_M_MESH_REQUESTS = REGISTRY.counter(
    "gordo_mesh_requests_total",
    "Requests scored by a mesh-sharded engine, by rung: owned = served "
    "from this shard's stacked fleet; fallback = a machine another shard "
    "owns, served here through the host-RAM spill tier — the ladder rung "
    "that keeps a dead shard's machines answering",
    labels=("shard", "path"),
)
_M_MESH_MACHINES = REGISTRY.gauge(
    "gordo_mesh_shard_machines",
    "Machines this shard owns in its stacked serving engine (mesh-sharded "
    "mode; every other machine serves via the fallback rung)",
    labels=("shard",),
)


# -- knobs (the reference's parse contract, kept as a copy) -------------------
def _round_up_pow2(n: int, minimum: int = 1) -> int:
    bucket = minimum
    while bucket < n:
        bucket *= 2
    return bucket


def _env_int(name: str, default: int, minimum: int = 0) -> int:
    """Integer env knob: unset → default; a non-integer warns and falls
    back (a bad env var must never fail a server boot); values clamp to
    ``minimum``."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        value = int(raw)
    except (TypeError, ValueError):
        logger.warning("%s=%r is not an int; using %d", name, raw, default)
        return default
    return max(minimum, value)


def _dispatch_depth() -> int:
    """``GORDO_DISPATCH_DEPTH``: in-flight dispatches per bucket. The
    default is core-aware: overlap needs a spare core for the collector,
    so hosts under 4 CPUs default to 1 (serial). Below 1 clamps to 1."""
    default = 2 if (os.cpu_count() or 1) >= 4 else 1
    return _env_int("GORDO_DISPATCH_DEPTH", default, minimum=1)


# ONE lock per PROCESS for shard-mode gathers, as the reference's for its
# sharded executions: it spans engine generations (a reload warms a new
# engine while the old one serves), so it cannot live on an engine. The hot
# cache exists to skip it.
_SHARD_DISPATCH_LOCK = lockcheck.named_lock("engine.shard_dispatch")


def _megabatch_enabled() -> bool:
    """``GORDO_MEGABATCH``: cross-machine fused dispatch through the
    resident stack (replicated engines; shard mode never megabatches). Any
    of 0/false/off/no disables; everything else, unset included, enables."""
    raw = os.environ.get("GORDO_MEGABATCH")
    if raw is None:
        return True
    return raw.strip().lower() not in ("0", "false", "off", "no")


def _megabatch_residency_cap() -> int:
    """``GORDO_MEGABATCH_RESIDENCY``: machines per bucket resident in the
    megabatch tier (default 128). A bucket at or under it is fully resident
    from boot; in a larger one a machine is admitted on its second cold
    hit. 0 disables megabatching; a non-integer falls back to the
    default."""
    return _env_int("GORDO_MEGABATCH_RESIDENCY", 128)


def _fill_window_us() -> int:
    """``GORDO_FILL_WINDOW_US``: the fill window in microseconds; core-aware
    default (250 with 4 or more CPUs, else 1000); 0 disables the wait.
    Requests already queued when a leader drains share its dispatch either
    way. Only megabatching engines wait."""
    default = 250 if (os.cpu_count() or 1) >= 4 else 1000
    return _env_int("GORDO_FILL_WINDOW_US", default)


# -- machines -----------------------------------------------------------------
class ScoreResult(NamedTuple):
    """Tail-aligned scoring arrays — the anomaly payload's field names."""

    model_input: np.ndarray  # (m, F) raw input rows the outputs align to
    model_output: np.ndarray  # (m, T) predictions in raw units
    tag_anomaly_scores: np.ndarray  # (m, T) error-scaled |residuals|
    total_anomaly_score: np.ndarray  # (m,) L2 norm across tags


def _identity(width: int) -> ScalerParams:
    return ScalerParams(scale=torch.ones(width), offset=torch.zeros(width))


def _affine(scaler: Optional[Any], width: int) -> ScalerParams:
    """A fitted affine scaler's (scale, offset) as host float32 tensors;
    identity when absent."""
    if scaler is None:
        return _identity(width)
    if not isinstance(scaler, (MinMaxScaler, StandardScaler)):
        raise ValueError(f"engine lifts affine scalers only; got {type(scaler).__name__}")
    if scaler.params_ is None:
        raise ValueError(f"{type(scaler).__name__} is not fitted")
    return ScalerParams(
        scale=torch.from_numpy(np.asarray(scaler.params_.scale, np.float32).copy()),
        offset=torch.from_numpy(np.asarray(scaler.params_.offset, np.float32).copy()),
    )


def _sidecar_matches(q_tree, params) -> bool:
    """Whether a stored int8 sidecar can stand in for ``params`` (both flax
    layout): the same nested keys and the same per-leaf shapes (the dtypes
    differ by design)."""
    if isinstance(q_tree, dict) != isinstance(params, dict):
        return False
    if not isinstance(params, dict):
        return np.shape(q_tree) == np.shape(params)
    return q_tree.keys() == params.keys() and all(
        _sidecar_matches(q_tree[key], params[key]) for key in params
    )


@dataclass
class _MachineEntry:
    """One machine's dispatchable tree, on the host."""

    name: str
    params: Dict[str, torch.Tensor]  # functional_call names → tensors
    sx: ScalerParams
    sy: ScalerParams
    es: ScalerParams
    tcols: torch.Tensor  # input-column index of each target tag
    # int8 machines only: each parameter's float32 scale, broadcastable to
    # it (``params`` then holds the int8 weights)
    params_scale: Optional[Dict[str, torch.Tensor]] = None

    def tree(self) -> Dict[str, Any]:
        tree = {"params": self.params, "sx": self.sx, "sy": self.sy,
                "es": self.es, "tcols": self.tcols}
        if self.params_scale is not None:
            tree["params_scale"] = self.params_scale
        return tree


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of machine trees of one structure: dicts,
    ``ScalerParams`` and tensors."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, ScalerParams):
        return ScalerParams(*(_tree_map(fn, *parts) for parts in zip(tree, *rest)))
    return {key: _tree_map(fn, tree[key], *(r[key] for r in rest)) for key in tree}


def _tree_leaves(tree) -> List[torch.Tensor]:
    leaves: List[torch.Tensor] = []
    _tree_map(leaves.append, tree)
    return leaves


def _meta_template(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` whose parameters and buffers live on the
    ``meta`` device: the bucket's forward, with no second copy of any
    weight. ``functional_call`` supplies the real (stacked) tensors."""
    memo = {
        id(p): torch.nn.Parameter(torch.empty_like(p, device="meta"), requires_grad=False)
        for p in module.parameters()
    }
    memo.update({id(b): torch.empty_like(b, device="meta") for b in module.buffers()})
    return copy.deepcopy(module, memo)


def _lift_machine(name: str, model: Any, target_cols, precision: Optional[str],
                  quantized_pair=None):
    """Analyze one model into its stacked-engine form: ``(estimator,
    architecture signature, _MachineEntry)`` with host tensors. Raises
    ``ValueError`` for a machine the engine cannot score (the reference's
    reasons). ``quantized_pair``: an int8 machine's stored ``(q_tree,
    scale_tree)`` in the flax layout, used when it matches the
    parameters."""
    analyzed = analyze_model(model)
    est = analyzed.estimator
    if est.module_ is None:
        raise ValueError("estimator is not fitted")
    if getattr(est, "joint_horizon", False):
        raise ValueError(
            "joint multi-step forecast emits horizon x F values "
            "per window; the anomaly engine scores one row per "
            "timestamp — use the direct-horizon LSTMForecast "
            "for anomaly serving"
        )
    n_features = int(est.n_features_)
    n_targets = int(est.n_features_out_)
    if target_cols is None:
        if n_targets != n_features:
            raise ValueError(
                f"targets are a {n_targets}-of-{n_features} "
                "subset but no target-column mapping was "
                "provided (target tags must be derivable from "
                "input tags)"
            )
        tcols = np.arange(n_features)
    else:
        tcols = np.asarray(target_cols, np.int64)
        if tcols.shape != (n_targets,):
            raise ValueError(
                f"target-column mapping has {tcols.shape[0]} "
                f"entries for {n_targets} targets"
            )
        if tcols.size and (tcols.min() < 0 or tcols.max() >= n_features):
            raise ValueError(
                "target-column mapping indexes outside the "
                f"{n_features}-wide input"
            )
    detector = analyzed.detector
    if detector is None:
        es = _identity(n_targets)
    elif getattr(detector.scaler, "params_", "unset") is None:
        if detector.require_thresholds:
            raise ValueError("error scaler unfitted and require_thresholds set")
        es = _identity(n_targets)  # the reference's fallback: raw |residuals|
    else:
        es = _affine(detector.scaler, n_targets)
    prec = precision_mod.validate(precision)
    params_scale = None
    with torch.device("meta"):  # the config only: no weights are allocated
        spec = est._make_spec(n_features, n_targets)
    if prec == "int8":
        pair = quantized_pair
        if pair is not None and not _sidecar_matches(pair[0], est.params_):
            # a stale sidecar (an older retrain's leaf shapes) would fail
            # the bucket's stack and the whole boot with it
            logger.warning(
                "Machine %r: stored int8 sidecar disagrees with the model "
                "params (tree or leaf shapes); quantizing on the fly instead",
                name,
            )
            pair = None
        if pair is None:
            pair = precision_mod.quantize_tree_int8(est.params_)
        params, params_scale = quantized_params_from_flax(
            lambda: est._make_spec(n_features, n_targets).module, *pair
        )
    else:
        # bf16: weights stored in bfloat16, host and device (half the
        # stacked bytes); the modules cast them to the compute dtype at use
        dtype = torch.bfloat16 if prec == "bf16" else None
        params = {
            key: value.detach().to("cpu", dtype=dtype or value.dtype)
            for key, value in est.module_.state_dict().items()
        }
    entry = _MachineEntry(
        name=name,
        params=params,
        sx=_affine(analyzed.input_scaler, n_features),
        sy=_affine(analyzed.target_scaler, n_targets),
        es=es,
        tcols=torch.as_tensor(tcols, dtype=torch.long),
        params_scale=params_scale,
    )
    sig = json.dumps(
        {
            "config": spec.config,
            "loss": spec.loss,
            "F": n_features,
            "T": n_targets,
            "L": est.lookback_window,
            "la": est.lookahead,
            # precision partitions the fleet into dtype-homogeneous buckets
            "precision": prec,
        },
        sort_keys=True,
        default=str,
    )
    return est, sig, entry


def _make_machine_score(lookback: int, lookahead: Optional[int], template, precision: str):
    """THE per-machine scoring math — scale → (window) → forward →
    inverse-scale → residual on the target columns → error-scale → L2 —
    over one machine tree and one request's rows. Every dispatch runs this
    one closure (under ``vmap`` for k requests, alone for one), so the
    paths cannot drift."""
    L, la = lookback, lookahead

    def machine_score(machine, x):
        params = machine["params"]
        if precision == "int8":
            # in the program, every dispatch: int8 on the device, float32
            # weights only for the forward's duration
            scales = machine["params_scale"]
            params = {key: q.to(torch.float32) * scales[key] for key, q in params.items()}
        xs = x * machine["sx"].scale + machine["sx"].offset
        inputs = xs if la is None else windowing.sliding_windows(xs, L, la)
        if precision == "bf16":
            inputs = inputs.to(torch.bfloat16)
        pred = torch.func.functional_call(template, params, (inputs,)).float()
        pred_raw = (pred - machine["sy"].offset) / machine["sy"].scale
        x_tail = x[x.shape[0] - pred_raw.shape[0] :]
        y_tail = x_tail.index_select(-1, machine["tcols"])
        err = (y_tail - pred_raw).abs()
        scaled = err * machine["es"].scale + machine["es"].offset
        total = torch.linalg.vector_norm(scaled, dim=-1)
        return x_tail, pred_raw, scaled, total

    return machine_score


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. On the card it is staged in pinned
    memory and copied without blocking: a blocking copy would wait for
    every dispatch already in flight on the stream."""
    tensor = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return tensor
    return tensor.pin_memory().to(device, non_blocking=True)


# -- the spill tier -------------------------------------------------------------
class SpillNotLiftable(Exception):
    """A lazily registered machine whose model the engine cannot lift (the
    eager boot's ``skipped`` rule). Its bundle is cached all the same; the
    server scores it on the host path, as an eager boot would."""


def _entry_host_tree(entry: _MachineEntry, device: torch.device) -> Dict[str, Any]:
    """One machine's dispatchable tree: the dict a bucket gathers for one
    slot (``_MachineEntry.tree``), so the spill program sees the same
    inputs. For a CUDA engine each leaf is pinned here, once per bundle,
    by PyTorch's caching host allocator: it records the stream of every
    copy made from a block, so an LRU eviction that drops the bundle while
    a non-blocking copy is in flight cannot hand the block out again."""
    tree = entry.tree()
    if device.type == "cuda":
        tree = _tree_map(lambda a: a.pin_memory(), tree)
    return tree


def _shape_key(lookback: int, lookahead: Optional[int], n_features: int) -> str:
    """An architecture's shape in traffic accounting's groups and the
    dispatch counts: ``L<lookback>[a<lookahead>]f<features>``."""
    return f"L{lookback}" + (f"a{lookahead}" if lookahead is not None else "") + f"f{n_features}"


def _compute_dtype(template: torch.nn.Module) -> str:
    """A template's compute dtype by name (``float32`` unless it says)."""
    return str(getattr(template, "dtype", torch.float32)).replace("torch.", "")


def _tree_nbytes(tree) -> int:
    return sum(a.numel() * a.element_size() for a in _tree_leaves(tree))


class _SpillScorer:
    """The spill tier's program for one architecture: a meta template of
    the estimator's module, as a bucket holds, and the one scoring closure
    (``_make_machine_score``), run unbatched on ONE machine's tree, as a
    bucket runs a lone request. So a spilled answer equals the same
    machine's lone eager answer to the bit on the same device. The lock
    covers the enqueue only, since ``functional_call`` swaps the shared
    template's parameters; the wait for the outputs runs outside it, so
    spill requests of one architecture overlap on the card."""

    def __init__(self, est, precision: str, device: torch.device):
        self.lookback = est.lookback_window
        self.lookahead = est.lookahead
        self.n_features = int(est.n_features_)
        self.precision = precision
        self.device = device
        self._offset = 0 if self.lookahead is None else self.lookback - 1 + self.lookahead
        self.template = _meta_template(est.module_)
        self._score = _make_machine_score(self.lookback, self.lookahead, self.template, precision)
        self._lock = lockcheck.named_lock("engine.spill")
        # the bucket's key for the same shape, and the dispatches enqueued,
        # so a caller can tie kernel launches to the spill path
        self.shape_key = _shape_key(self.lookback, self.lookahead, self.n_features)
        self.dispatch_count = 0

    def enqueue(self, tree: Dict[str, Any], x: np.ndarray, m_valid: int):
        """Copy ``tree`` to the device and enqueue the score of ``x``'s
        first ``m_valid`` + offset rows (the rows a bucket computes for a
        lone request) under the lock, then, outside it, the outputs' copy to
        pinned host memory and a CUDA event; returns ``(host tensors, event
        or None)``."""
        rows = x[: m_valid + self._offset]
        with self._lock, torch.inference_mode():
            machine = _tree_map(lambda a: a.to(self.device, non_blocking=True), tree)
            outputs = self._score(machine, _to_device(rows, self.device))
            self.dispatch_count += 1
        if self.device.type != "cuda":
            return outputs, None
        # behind the work on the same stream, outside the lock, as a
        # bucket's enqueue does
        host = tuple(t.to("cpu", non_blocking=True) for t in outputs)
        done = torch.cuda.Event(blocking=True)
        done.record(torch.cuda.current_stream(self.device))
        return host, done


# -- the pipeline (the reference's) -------------------------------------------
class _Item:
    __slots__ = ("idx", "x", "m_valid", "in_flight", "done", "result", "error",
                 "ctx", "klass")

    def __init__(self, idx: int, x: np.ndarray, m_valid: int):
        self.idx = idx
        self.x = x
        self.m_valid = m_valid
        # captured on the submitting thread: the leader that dispatches this
        # item and the collector that fetches it know nothing of its
        # request's context variables. The class orders the drain, the
        # context routes the stages and the collector's log records.
        self.klass = qos.current_class()
        self.ctx = spans.capture()
        # set (under the bucket condition) when a leader pops this item off
        # the pending queue: a woken waiter whose item is in flight must
        # wait for the collector, not elect itself leader
        self.in_flight = False
        self.done = threading.Event()
        self.result: Optional[ScoreResult] = None
        self.error: Optional[BaseException] = None


class _Dispatch:
    """One in-flight dispatch: its path (``cold``, ``hot`` or ``mega``), its
    enqueued (not yet fetched) outputs and what the fetch stage needs to
    fan them out."""

    __slots__ = ("kind", "rows", "items", "outputs", "started", "enqueued", "hot_idx")

    def __init__(self, kind: str, rows: int, items: List[_Item], outputs, started: float,
                 enqueued: float, hot_idx: Optional[int] = None):
        self.kind = kind
        self.rows = rows
        self.items = items
        self.outputs = outputs  # (host tensors, CUDA event or None)
        self.started = started  # perf_counter when the enqueue began
        # perf_counter when the enqueue returned: the device_execute span
        # runs from here to the start of the fetch
        self.enqueued = enqueued
        self.hot_idx = hot_idx  # the machine a hot dispatch scored


class _Stop:
    """close() sentinel, addressed to ONE collector thread: a successor
    collector spawned while the old one was retiring discards a stale
    sentinel and keeps draining."""

    __slots__ = ("thread",)

    def __init__(self, thread: threading.Thread):
        self.thread = thread


class _DepthGate:
    """A semaphore whose permit count can be resized live: a shrink stops
    new acquires until in-flight work drains below the new depth, a grow
    wakes waiting leaders at once."""

    __slots__ = ("_depth_cond", "_depth", "_in_use")

    def __init__(self, depth: int):
        self._depth_cond = lockcheck.named_condition("engine.depth")
        self._depth = max(1, int(depth))
        self._in_use = 0

    def acquire(self) -> None:
        with self._depth_cond:
            while self._in_use >= self._depth:
                self._depth_cond.wait()
            self._in_use += 1

    def release(self) -> None:
        with self._depth_cond:
            self._in_use -= 1
            self._depth_cond.notify_all()

    def resize(self, depth: int) -> int:
        with self._depth_cond:
            self._depth = max(1, int(depth))
            self._depth_cond.notify_all()
            return self._depth


def _collector_loop(bucket_ref: "weakref.ref", fetch_queue: "queue.Queue"):
    """Per-bucket fetch stage, FIFO in dispatch order. Holds only a weak
    reference between jobs, so a dropped engine (never closed) can be
    collected and the thread exits at its next idle tick."""
    while True:
        try:
            job = fetch_queue.get(timeout=5.0)
        except queue.Empty:
            if bucket_ref() is None:
                return
            continue
        if isinstance(job, _Stop):  # FIFO, so in-flight work drained first
            fetch_queue.task_done()
            if job.thread is threading.current_thread():
                return
            continue  # a predecessor's sentinel; this collector lives on
        bucket = bucket_ref()
        if bucket is None:
            for it in job.items:
                it.error = RuntimeError("serving bucket was released")
                it.done.set()
            fetch_queue.task_done()
            continue
        try:
            with nan_guard():  # a repair rescores on this thread
                bucket._complete(job)
        finally:
            bucket._inflight_slots.release()
            # after _complete (and any isolated retry): quiesce() joins on
            # this, so "fetch stage drained" implies every waiter answered
            fetch_queue.task_done()
            # drop both strong refs before blocking again: a failed job's
            # traceback references the engine
            del bucket, job


class _Bucket:
    """One architecture's stacked machines: on one device (replicated), or
    in one chunk per device of a shard-mode ``mesh`` (see the module
    docstring)."""

    def __init__(
        self,
        template: torch.nn.Module,
        lookback: int,
        lookahead: Optional[int],
        entries: List[_MachineEntry],
        max_batch: int,
        device: torch.device,
        fill_window_s: float = 0.0,
        precision: str = "f32",
        mesh: Optional[List[torch.device]] = None,
        hot_cap: int = 0,
        megabatch: bool = False,
        mega_cap: int = 0,
    ):
        self.template = template
        # the kernel libraries the program launches on the card, resolved
        # before a dispatch takes the template lock (ServingEngine._anomaly)
        self.libraries = _kernels.libraries_for(template)
        # functional_call swaps the template's parameters for a call's
        # duration, and the program runs on leader and collector threads
        # alike: one call at a time per template
        self._template_lock = lockcheck.named_lock("engine.template")
        self.device = device
        self.precision = precision  # one rung per bucket: no program mixes dtypes
        self.lookback = lookback
        self.lookahead = lookahead
        # rows a window reads past its first: window i covers rows
        # [i, i + offset]; 0 for a flat (one row per score) model
        self._offset = 0 if lookahead is None else lookback - 1 + lookahead
        self.max_batch = max_batch
        self.names = [e.name for e in entries]  # the real machines, never the padding
        self.n_features = int(entries[0].sx.scale.shape[0])
        # the bucket's shape in traffic accounting's groups (one value per
        # bucket, so bounded by construction)
        self.shape_key = _shape_key(lookback, lookahead, self.n_features)
        self.mesh = list(mesh) if mesh else None
        # shard mode: ``chunks[c]`` holds rows [c·chunk, (c+1)·chunk) of the
        # padded stack on ``mesh[c]``, and ``stacked`` is None
        self.chunks: Optional[List[Dict[str, Any]]] = None
        self._chunk = 0
        if self.mesh is not None:
            # pad with entry 0 so the machine axis splits evenly; a padded
            # row is never dispatched (only real indices are)
            n_pad = pad_to_multiple(len(entries), len(self.mesh))
            entries = entries + [entries[0]] * (n_pad - len(entries))
            self._chunk = n_pad // len(self.mesh)
        # stack on the host, place on the device(s) once
        host = _tree_map(lambda *leaves: torch.stack(leaves), *[e.tree() for e in entries])
        if self.mesh is None:
            self.stacked = _tree_map(lambda a: a.to(device), host)
        else:
            # each chunk is a copy of its own (a CPU chunk too), so the
            # whole stack never sits on one device
            size = self._chunk
            self.chunks = [
                _tree_map(lambda a, c=c, dev=dev: a[c * size:(c + 1) * size].to(dev, copy=True),
                          host)
                for c, dev in enumerate(self.mesh)
            ]
            self.stacked = None
        del host
        self._score = _make_machine_score(lookback, lookahead, template, precision)
        self._batched = torch.func.vmap(self._score)
        # (path, padded rows, k) of every dispatch this bucket ran, warm-ups
        # included: the reference's compiled programs, which an eager program
        # does not have; a new shape still pays its first allocations
        self._programs: set = set()
        # shard-mode hot cache: machine -> a copy of its slice (a stack of
        # height one) on the dispatch device. Routing (the leader) and
        # promotion and demotion (the fetch stage) take ``_hot_lock``; the
        # promotion's gather runs outside it.
        self._hot_cap = int(hot_cap) if self.mesh is not None else 0
        self._hot: "OrderedDict[int, Any]" = OrderedDict()
        self._hot_hits: Dict[int, int] = {}
        self._hot_last_use: Dict[int, int] = {}  # idx -> dispatch_count
        self._hot_demotions: Dict[int, int] = {}
        self._hot_lock = lockcheck.named_lock("engine.hot")
        self.hot_request_count = 0
        # the megabatch residency tier (replicated engines only): the
        # resident machines in LRU order, each served from its own row of
        # ``stacked`` (slot = machine). Routing reads them under
        # ``_mega_lock``; every mutation runs on the one thread that runs
        # _complete, under it too.
        self._mega_enabled = bool(megabatch) and self.mesh is None and mega_cap > 0
        self._mega_cap = int(mega_cap)
        self._mega_full = self._mega_enabled and len(self.names) <= self._mega_cap
        self._mega_lock = lockcheck.named_lock("engine.mega")
        self._mega_slots: "OrderedDict[int, None]" = OrderedDict()
        if self._mega_full:
            self._mega_slots.update((i, None) for i in range(len(self.names)))
        self._mega_hits: Dict[int, int] = {}
        self._mega_last_use: Dict[int, int] = {}
        self._mega_demotions: Dict[int, int] = {}
        # the layout plan's pins: seeded hit counters promote a pinned
        # machine on its next cold hit, and eviction skips it
        self._mega_pinned: set = set()
        # the fill window engages only under megabatching
        self._fill_s = max(0.0, fill_window_s) if self._mega_enabled else 0.0
        self._filling = False  # a leader is inside its fill window
        self.fill_timeout_count = 0
        self.fill_size_count = 0
        # repairs of a dispatch of several requests (mega or cold), under the
        # reference's names: one that failed at enqueue (fallback_cold) or at
        # fetch (retry_isolated) is rescored one request per cold dispatch
        self.fallback_cold_count = 0
        self.retry_isolated_count = 0
        self._cond = lockcheck.named_condition("engine.bucket_cond")
        self._busy = False
        self._pending: Dict[int, List[_Item]] = {}
        self.dispatch_depth = _dispatch_depth()
        self._inflight_slots = _DepthGate(self.dispatch_depth)
        self._fetch_queue: "queue.Queue" = queue.Queue()
        self._collector: Optional[threading.Thread] = None
        # serializes collector handover (spawn / close / enqueue)
        self._collector_lock = lockcheck.named_lock("engine.collector")
        self._retiring_collector: Optional[threading.Thread] = None
        self.dispatch_count = 0
        self.request_count = 0
        self.mega_dispatch_count = 0
        self.mega_request_count = 0
        self.max_batch_seen = 0
        # dispatches of the warm-ups of the hot and mega paths, which score
        # no request (the launches they make are the bucket's all the same)
        self.warm_dispatch_count = 0
        # seconds from each dispatch's enqueue to its fetched outputs, summed:
        # the cost ledger's per-rung latency numerator
        self.dispatch_seconds_total = 0.0

    def stacked_nbytes(self) -> int:
        """Device bytes held by this bucket's stack: every chunk in shard
        mode, padding included (int8 weights count one byte each)."""
        trees = self.chunks if self.chunks is not None else [self.stacked]
        return sum(_tree_nbytes(tree) for tree in trees)

    # -- the program -----------------------------------------------------------
    def _program(self, idxs: List[int], xs: np.ndarray, stack=None):
        """The bucket's one program: machines ``idxs`` of ``stack`` (the
        bucket's own stack when None) scored on their rows ``xs`` (k, n, F)
        in one dispatch; device outputs with a leading k axis, not yet
        computed. k > 1 requests run under ``vmap`` over the machines
        gathered by ``index_select``, so each layer is one batched kernel
        for all k. A lone request runs unbatched on views of its machine's
        slices: there a product keeps its bias in the GEMM, where under
        ``vmap`` each bias is its own pass over the activations. The cold
        path of shard mode gathers from the chunks (``_gather``) first."""
        # grad mode is thread-local, so each call enters inference mode
        with self._template_lock, torch.inference_mode():
            rows = _to_device(xs, self.device)
            if stack is None and self.chunks is not None:
                machines = self._gather(idxs)  # (k, ...) in batch order
            else:
                stack = self.stacked if stack is None else stack
                if len(idxs) == 1:
                    i = int(idxs[0])
                    machines = _tree_map(lambda a: a[i:i + 1], stack)
                else:
                    idx = _to_device(np.asarray(idxs, np.int64), self.device)
                    machines = _tree_map(lambda a: a.index_select(0, idx), stack)
            if len(idxs) == 1:
                machine = _tree_map(lambda a: a[0], machines)
                return tuple(t.unsqueeze(0) for t in self._score(machine, rows[0]))
            return self._batched(machines, rows)

    def _gather(self, idxs: List[int]) -> Dict[str, Any]:
        """Shard mode: the k machines ``idxs`` as a stack of height k on the
        dispatch device, in batch order. Each machine index is a (chunk,
        row); each chunk's rows are gathered by ``index_select`` (a copy)
        on its device and brought over, under the process-wide shard lock
        (only this window of the dispatch runs under it)."""
        by_chunk: Dict[int, List[Tuple[int, int]]] = {}
        for position, idx in enumerate(idxs):
            chunk, row = divmod(int(idx), self._chunk)
            by_chunk.setdefault(chunk, []).append((position, row))
        order: List[int] = []
        with _SHARD_DISPATCH_LOCK:
            parts = []
            for chunk in sorted(by_chunk):
                picks = by_chunk[chunk]
                sel = _to_device(np.asarray([row for _, row in picks], np.int64),
                                 self.mesh[chunk])
                parts.append(_tree_map(lambda a: a.index_select(0, sel).to(self.device),
                                       self.chunks[chunk]))
                order.extend(position for position, _ in picks)
        gathered = parts[0] if len(parts) == 1 else _tree_map(
            lambda *leaves: torch.cat(leaves), *parts)
        if order != sorted(order):
            # concatenated in chunk order: put the machines in batch order
            back = _to_device(np.argsort(np.asarray(order)).astype(np.int64), self.device)
            gathered = _tree_map(lambda a: a.index_select(0, back), gathered)
        return gathered

    def _gather_machine(self, idx: int) -> Dict[str, Any]:
        """One machine's slice as a stack of height one on the dispatch
        device, a copy (the hot cache's entry), under the shard lock."""
        chunk, row = divmod(int(idx), self._chunk)
        with _SHARD_DISPATCH_LOCK:
            return _tree_map(lambda a: a[row:row + 1].to(self.device, copy=True),
                             self.chunks[chunk])

    def _warm(self, kind: str, rows: int, n: int, stack) -> None:
        """One synthetic lone dispatch of ``n`` zero rows through the first
        machine of ``stack`` (None: the bucket's own), fetched; ``rows`` is
        the padded row bucket the key names."""
        xs = np.zeros((1, n, self.n_features), np.float32)
        with nan_guard():
            self._host(self._enqueue([0], xs, stack))
        self.warm_dispatch_count += 1
        self._programs.add((kind, rows, 1))

    def warmup_hot(self, rows: int, n: int) -> None:
        """Shard mode: pay the hot path's one-time costs before traffic, one
        promotion gather and one hot dispatch at the warmed row bucket. The
        gathered copy is dropped: promotion still takes two cold hits."""
        if not self._hot_cap:
            return
        self._warm("hot", rows, n, self._gather_machine(0))

    def warmup_mega(self, rows: int, n: int) -> None:
        """A partial bucket boots with no resident machine, so its warm-up
        request scores cold: one synthetic mega dispatch of its first
        machine records the mega path's shape too, as the reference's
        warm-up does. A full bucket's warm-up request already ran it."""
        if not self._mega_enabled or self._mega_full:
            return
        self._warm("mega", rows, n, None)

    # -- request path ----------------------------------------------------------
    def submit(self, idx: int, x: np.ndarray, m_valid: int) -> ScoreResult:
        """Score one request; coalesces with concurrent requests of the
        same padded row count. One thread at a time is the leader: it
        drains the queue into dispatches, only ENQUEUES each (bounded by
        the dispatch depth), and releases the latch once the queue is
        drained or its own item completed."""
        item = _Item(idx, x, m_valid)
        if self.precision != "f32":
            # a request served on a lower rung says so in its own timeline
            spans.event_into(item.ctx, "precision_downgraded",
                             precision=self.precision, machine=self.names[idx])
        rows = x.shape[0]
        is_leader = False
        queued = time.perf_counter()
        with self._cond:
            self._pending.setdefault(rows, []).append(item)
            if self._filling:
                self._cond.notify_all()  # a filling leader waits for arrivals
            while True:
                if item.done.is_set() or item.in_flight:
                    break  # a leader dispatched it; await the fetch stage
                if not self._busy:
                    self._busy = True
                    is_leader = True
                    break
                self._cond.wait(timeout=1.0)  # predicate-looped hang guard
        # queue_wait: from joining the queue until a leader took this item,
        # this thread became the leader, or a racing leader completed it
        spans.record_into(item.ctx, "queue_wait", queued, time.perf_counter() - queued)
        if is_leader:
            try:
                self._fill_window(item)
                while not item.done.is_set():
                    with self._cond:
                        pending, self._pending = self._pending, {}
                        for batch in pending.values():
                            for it in batch:
                                it.in_flight = True
                        if pending:
                            # wake coalesced followers now: their predicate
                            # flipped, and this loop may run a long time
                            self._cond.notify_all()
                    if not pending:
                        break
                    # weighted-fair order within each row bucket: a bulk flood
                    # fills the tail dispatches of a drain, not every slot
                    # of the first; a single-class round keeps its order
                    batches = [
                        (batch_rows, fair[start : start + self.max_batch])
                        for batch_rows, items in pending.items()
                        for fair in (qos.weighted_interleave(items, lambda it: it.klass),)
                        for start in range(0, len(items), self.max_batch)
                    ]
                    for i, (batch_rows, batch_items) in enumerate(batches):
                        # hand the fetch to the collector only when there is
                        # more work to overlap it with; an idle singleton
                        # fetches inline
                        self._dispatch(batch_rows, batch_items, defer=(i + 1 < len(batches)))
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()
        item.done.wait()
        if item.error is not None:
            raise item.error
        assert item.result is not None
        return item.result

    def _fill_window(self, item: _Item) -> None:
        """A new leader with evidence of concurrency (other requests
        pending, or dispatches in flight) holds its first drain for up to
        the window, collecting submits across machines; a full
        ``max_batch`` pending closes it early; a lone request on an idle
        bucket bypasses it."""
        window = self._fill_s
        if not window or item.done.is_set():
            return
        started = time.perf_counter()
        deadline_at = started + window
        size_triggered = False
        largest = 0
        with self._cond:
            total = sum(len(v) for v in self._pending.values())
            if total <= 1 and self._fetch_queue.unfinished_tasks == 0:
                return
            self._filling = True
            try:
                while True:
                    # the size trigger counts the largest single-shape
                    # batch: requests of different row buckets never fuse
                    largest = max((len(v) for v in self._pending.values()), default=0)
                    if largest >= self.max_batch:
                        size_triggered = True
                        break
                    remaining = deadline_at - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            finally:
                self._filling = False
        trigger = "size" if size_triggered else "timeout"
        if size_triggered:
            self.fill_size_count += 1
        else:
            self.fill_timeout_count += 1
        _M_FILL_TRIGGER.labels(trigger).inc()
        _M_FILL_OCCUPANCY.observe(min(1.0, largest / float(self.max_batch)))
        # how long THIS request's leader held the window, and what it saw
        spans.record_into(item.ctx, "megabatch", started, time.perf_counter() - started,
                          trigger=trigger, collected=largest)

    def _should_pipeline(self) -> bool:
        """Pipeline the fetch when the collector already has work or new
        requests queued meanwhile; ``unfinished_tasks`` only rises on this
        (the leader) thread, so a zero read is stable."""
        if self._fetch_queue.unfinished_tasks > 0:
            return True
        with self._cond:
            return bool(self._pending)

    def _batch_inputs(self, items: List[_Item]) -> np.ndarray:
        """``(k, n, F)`` rows of the batch. Each request is padded to the
        bucket's row count, but ``n`` is only as many rows as the longest
        real request holds: a window fanned out to a request reads only
        that request's real rows (window i covers rows [i, i + offset],
        and i < m_valid), so the zero rows past ``n`` feed no result and
        are not computed."""
        n = max(it.m_valid for it in items) + self._offset
        return np.stack([it.x[:n] for it in items])

    def _enqueue(self, idxs: List[int], xs: np.ndarray, stack=None):
        """Run the program (over ``stack``, else the bucket's own) and
        enqueue its outputs' copy to pinned host memory behind it, then a
        CUDA event behind that; returns ``(host tensors, event)`` (the
        event is None on the CPU, where the work is done on return)."""
        outputs = self._program(idxs, xs) if stack is None else self._program(idxs, xs, stack)
        if self.device.type != "cuda":
            return outputs, None
        host = tuple(t.to("cpu", non_blocking=True) for t in outputs)
        done = torch.cuda.Event(blocking=True)
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    @staticmethod
    def _host(outputs) -> Tuple[np.ndarray, ...]:
        """Wait for an enqueued dispatch and view its outputs as arrays."""
        host, done = outputs
        if done is not None:
            done.synchronize()
        return tuple(t.numpy() for t in host)

    def _dispatch(self, rows: int, items: List[_Item], defer: bool) -> None:
        """Route one drained batch: mega when every machine in it is
        resident; hot when it is a pure batch of one machine with a hot
        copy (shard mode); else cold. Every path runs under the numeric
        sanitizer while it is on (``utils.backend.nan_guard``)."""
        with nan_guard():
            if self._mega_enabled and self._mega_route(items):
                self._dispatch_mega(rows, items, defer)
                return
            hot = None
            idx0 = items[0].idx
            if self._hot_cap and all(it.idx == idx0 for it in items):
                with self._hot_lock:
                    hot = self._hot.get(idx0)
                    if hot is not None:
                        self._hot.move_to_end(idx0)  # LRU touch
            if hot is not None:
                self._dispatch_hot(rows, idx0, hot, items, defer)
            else:
                self._dispatch_cold(rows, items, defer)

    def _mega_route(self, items: List[_Item]) -> bool:
        """Whether every item's machine is resident (then each is touched
        in the LRU)."""
        with self._mega_lock:
            if any(it.idx not in self._mega_slots for it in items):
                return False
            for it in items:
                self._mega_slots.move_to_end(it.idx)  # LRU touch
        return True

    def _enqueued(self, kind: str, rows: int, items: List[_Item], enqueue, defer: bool,
                  hot_idx: Optional[int] = None) -> Optional[Exception]:
        """Acquire an in-flight slot, run ``enqueue()`` and hand the dispatch
        to its fetch stage. An ``Exception`` at enqueue is returned (the slot
        released) for the caller's repair; an interrupt fails the waiters."""
        acquired = False
        try:
            self._inflight_slots.acquire()  # backpressure: bounded depth
            acquired = True
            started = time.perf_counter()
            outputs = enqueue()
        except Exception as exc:
            if acquired:
                self._inflight_slots.release()
            return exc
        except BaseException as exc:  # interrupt/exit: surface, don't retry
            if acquired:
                self._inflight_slots.release()
            self._fail(items, exc)
            return None
        enqueued = time.perf_counter()
        self._programs.add((kind, rows, len(items)))
        machines = len({it.idx for it in items})
        for it in items:
            # the leader may be another request's thread: each item's own
            # timeline gets the span
            spans.record_into(it.ctx, "dispatch", started, enqueued - started, path=kind,
                              batch=len(items), machines=machines)
        self._finish(_Dispatch(kind, rows, items, outputs, started, enqueued, hot_idx), defer)
        return None

    def _dispatch_cold(self, rows: int, items: List[_Item], defer: bool) -> None:
        try:
            xs = self._batch_inputs(items)
        except Exception as exc:
            self._fail(items, exc)
            return
        exc = self._enqueued("cold", rows, items,
                             lambda: self._enqueue([it.idx for it in items], xs), defer)
        if exc is None:
            return
        if len(items) == 1:
            # a lone request's enqueue failure surfaces on its waiter
            spans.event_into(items[0].ctx, "dispatch_error", error=type(exc).__name__,
                             path="cold")
            self._fail(items, exc)
            return
        # one bad machine (or a batch too large for the device) must not fail
        # the other machines' waiters: each request is rescored in a cold
        # dispatch of its own
        logger.exception("cold dispatch of %d request(s) failed at enqueue; rescoring one "
                         "request per cold dispatch", len(items), exc_info=exc)
        self._fall_back_cold(rows, items, exc, defer)

    def _fall_back_cold(self, rows: int, items: List[_Item], exc: Exception,
                        defer: bool) -> None:
        """Rescore a batch that failed at enqueue one request per cold
        dispatch."""
        self.fallback_cold_count += 1
        _M_MEGA_EVENTS.labels("fallback_cold").inc()
        for it in items:
            spans.event_into(it.ctx, "megabatch_fallback_cold", error=type(exc).__name__)
        for it in items:
            self._dispatch_cold(rows, [it], defer)

    def _dispatch_mega(self, rows: int, items: List[_Item], defer: bool) -> None:
        try:
            xs = self._batch_inputs(items)
        except Exception as exc:
            self._fail(items, exc)
            return
        exc = self._enqueued("mega", rows, items,
                             lambda: self._enqueue([it.idx for it in items], xs), defer)
        if exc is None:
            return
        # the fused path must never fail a request the cold path could
        # serve: its machines leave residency (they re-earn it under
        # backoff) and each request is rescored in a cold dispatch of its
        # own, so one bad machine fails only its own waiters
        logger.exception(
            "megabatch dispatch of %d request(s) failed at enqueue; demoting its "
            "machines and rescoring one request per cold dispatch", len(items),
            exc_info=exc)
        for idx in {it.idx for it in items}:
            self._mega_demote(idx)
        self._fall_back_cold(rows, items, exc, defer)

    def _dispatch_hot(self, rows: int, idx: int, tree, items: List[_Item],
                      defer: bool) -> None:
        try:
            xs = self._batch_inputs(items)
        except Exception as exc:
            self._fail(items, exc)
            return
        exc = self._enqueued("hot", rows, items,
                             lambda: self._enqueue([0] * len(items), xs, tree), defer,
                             hot_idx=idx)
        if exc is None:
            return
        # a failing hot copy must not keep failing its machine's pure
        # batches while the cold path could serve them: demote it (its
        # re-promotion backs off) and score the same items cold
        logger.exception("hot-cache dispatch failed for machine idx %d; demoting the hot "
                         "copy and retrying on the cold path", idx, exc_info=exc)
        self._demote(idx)
        self._dispatch_cold(rows, items, defer)

    def _finish(self, job: _Dispatch, defer: bool) -> None:
        """Route one enqueued dispatch to its fetch stage: the collector when
        pipelining pays, else inline on the leader (the collector is then
        provably idle, so _complete stays single-threaded)."""
        if defer or self._should_pipeline():
            try:
                with self._collector_lock:
                    # spawn-and-enqueue is atomic w.r.t. close(): the job
                    # either lands ahead of a shutdown sentinel or a fresh
                    # collector is spawned for it
                    self._ensure_collector()  # lint: allow-blocking(handover join: the retiring collector exits within its in-flight fetches and never takes this lock, so the join is deadlock-free and rarer than a reload)
                    self._fetch_queue.put(job)
            except BaseException as exc:
                # a failed spawn fans out like any dispatch failure
                self._inflight_slots.release()
                self._fail(job.items, exc)
            return
        try:
            self._complete(job)
        finally:
            self._inflight_slots.release()

    @staticmethod
    def _fail(items: List[_Item], exc: BaseException) -> None:
        for it in items:
            it.error = exc
        for it in items:
            it.done.set()

    # -- fetch stage -----------------------------------------------------------
    def _ensure_collector(self) -> None:
        """Start the collector lazily (callers hold _collector_lock). A
        retiring predecessor is joined first, so exactly one thread ever
        runs _complete."""
        if self._collector is not None and self._collector.is_alive():
            return
        retiring = self._retiring_collector
        if retiring is not None and retiring.is_alive():
            retiring.join(timeout=30.0)
            if retiring.is_alive():
                logger.warning(
                    "Collector handover: predecessor still draining after 30 s; "
                    "waiting it out to keep a single consumer"
                )
                retiring.join()
        self._retiring_collector = None
        self._collector = threading.Thread(
            target=_collector_loop,
            args=(weakref.ref(self), self._fetch_queue),
            name="gordo-bucket-collector",
            daemon=True,
        )
        self._collector.start()

    def close(self) -> None:
        """Stop the collector after draining in-flight work. Idempotent; a
        later dispatch starts a new one on demand."""
        with self._collector_lock:
            collector, self._collector = self._collector, None
            if collector is None or not collector.is_alive():
                return
            self._fetch_queue.put(_Stop(collector))
            self._retiring_collector = collector
        collector.join(timeout=30.0)

    def quiesce(self) -> None:
        """Block until every dispatch enqueued so far is fetched and fanned
        out, the promotions that ride the fetch stage included."""
        self._fetch_queue.join()

    def _fetch(self, job: _Dispatch):
        """The wait and device-to-host copy of one dispatch's outputs — a
        seam the tests fail deliberately."""
        return self._host(job.outputs)

    def _complete(self, job: _Dispatch) -> None:
        """Fetch one dispatch and fan out, errors included: an execution
        failure surfaces here, on exactly this job's waiters. Runs bound to
        the first item's span context: this thread inherits none of the
        request's, and its log records then carry that trace id (spans go
        to each item's own timeline)."""
        with spans.bind(job.items[0].ctx if job.items else spans.EMPTY_CONTEXT):
            self._complete_bound(job)

    def _complete_bound(self, job: _Dispatch) -> None:
        fetch_started = time.perf_counter()
        for it in job.items:
            # enqueue to fetch start: the window the device computes in
            spans.record_into(it.ctx, "device_execute", job.enqueued,
                              fetch_started - job.enqueued, path=job.kind)
        try:
            x_tail, pred, scaled, total = self._fetch(job)
        except Exception as exc:
            if job.kind == "hot":
                # the enqueue-time contract, caught at the fetch: demote the
                # hot copy and rescore the same items cold, on this thread
                logger.exception("hot-cache fetch failed for machine idx %d; demoting the "
                                 "hot copy and retrying on the cold path", job.hot_idx)
                for it in job.items:
                    spans.event_into(it.ctx, "hot_fetch_failed_retry_cold",
                                     error=type(exc).__name__)
                self._demote(job.hot_idx)
                self._retry_cold_sync(job.items)
                return
            if job.kind == "mega" or len(job.items) > 1:
                # a fused execution is all or nothing: a mega batch's
                # machines leave residency first (the culprit may be one
                # machine or the program), then each request is rescored in
                # its own cold dispatch, so one bad machine (or a batch too
                # large for the device) fails only its own waiters
                logger.exception(
                    "%s fetch failed for a %d-request batch; rescoring one request per "
                    "cold dispatch", job.kind, len(job.items),
                )
                self.retry_isolated_count += 1
                _M_MEGA_EVENTS.labels("retry_isolated").inc()
                for it in job.items:
                    spans.event_into(it.ctx, "megabatch_fetch_failed_retry_isolated",
                                     error=type(exc).__name__)
                if job.kind == "mega":
                    for idx in {it.idx for it in job.items}:
                        self._mega_demote(idx)
                self._retry_isolated_sync(job.items, f"{job.kind}-fetch-failure")
                return
            for it in job.items:
                spans.event_into(it.ctx, "fetch_error", error=type(exc).__name__,
                                 path=job.kind)
            self._fail(job.items, exc)
            return
        except BaseException as exc:
            self._fail(job.items, exc)
            return
        fetched = time.perf_counter()
        for it in job.items:
            spans.record_into(it.ctx, "fetch", fetch_started, fetched - fetch_started,
                              path=job.kind, batch=len(job.items))
        _M_DISPATCH_SECONDS.labels(job.kind).observe(fetched - job.started)
        self.dispatch_seconds_total += fetched - job.started
        try:
            # results are filled before any accounting: a fill failure
            # errors the waiters without counting them as served
            self._fill_results(job.items, x_tail, pred, scaled, total)
            self._account(len(job.items), job.kind)
            if job.kind == "mega":
                _M_MEGA_BATCH.observe(len(job.items))
                _M_MEGA_MACHINES.observe(len({it.idx for it in job.items}))
                with self._mega_lock:
                    for idx in {it.idx for it in job.items}:
                        self._mega_last_use[idx] = self.dispatch_count
                        self._pay_down_demotions(self._mega_demotions, idx)
            elif job.kind == "hot":
                with self._hot_lock:
                    self._hot_last_use[job.hot_idx] = self.dispatch_count
                    self._pay_down_demotions(self._hot_demotions, job.hot_idx)
        except BaseException as exc:
            for it in job.items:
                it.error = exc
        finally:
            for it in job.items:
                it.done.set()
        if job.kind != "cold" or not job.items or job.items[0].error is not None:
            return
        # after the waiters are released: a failed promotion never turns
        # their success into an error, and is retried by the next cold hit.
        # Cold successes feed both caches (hot is shard mode's, mega the
        # replicated engine's: at most one is live)
        self._promote_after(job.items)

    def _promote_after(self, items: List[_Item]) -> None:
        try:
            self._maybe_promote(items)
        except Exception:
            logger.exception("hot-cache promotion failed (serving unaffected)")
        try:
            self._maybe_promote_mega(items)
        except Exception:
            logger.exception("megabatch residency promotion failed (serving unaffected)")

    def _score_sync(self, items: List[_Item], retry: str) -> None:
        """Score ``items`` in one cold dispatch, synchronously on this
        thread (a repair path, not the pipeline), fill and account them;
        raises what the dispatch raised."""
        started = time.perf_counter()
        outputs = self._enqueue([it.idx for it in items], self._batch_inputs(items))
        enqueued = time.perf_counter()
        x_tail, pred, scaled, total = self._host(outputs)
        fetched = time.perf_counter()
        for it in items:
            spans.record_into(it.ctx, "dispatch", started, enqueued - started, path="cold",
                              retry=retry)
            spans.record_into(it.ctx, "fetch", enqueued, fetched - enqueued, path="cold",
                              retry=retry)
        _M_DISPATCH_SECONDS.labels("cold").observe(fetched - started)
        self.dispatch_seconds_total += fetched - started
        self._fill_results(items, x_tail, pred, scaled, total)
        self._account(len(items), "cold")

    def _retry_cold_sync(self, items: List[_Item]) -> None:
        """The cold retry of a hot dispatch that failed at fetch: the same
        batch in one cold dispatch, then the cold path's promotion
        accounting (the demoted machine starts re-earning its copy)."""
        try:
            self._score_sync(items, "hot-fetch-failure")
        except BaseException as exc:
            for it in items:
                it.error = exc
        finally:
            for it in items:
                it.done.set()
        if items and items[0].error is None:
            self._promote_after(items)

    def _retry_isolated_sync(self, items: List[_Item], retry: str) -> None:
        """Rescore a batch that failed at fetch ONE request at a time in
        cold dispatches, synchronously on the collector. A sticky device
        fault fails each request once and ends the loop: nothing is retried
        twice. A request whose own retry fails leaves residency too."""
        for item in items:
            try:
                self._score_sync([item], retry)
            except BaseException as exc:
                item.error = exc
                spans.event_into(item.ctx, "megabatch_isolated_retry_failed",
                                 error=type(exc).__name__)
                try:
                    self._mega_demote(item.idx)
                except Exception:  # pragma: no cover - bookkeeping only
                    logger.exception("megabatch demotion failed")
            finally:
                item.done.set()

    # -- residency: the hot cache and the megabatch tier ---------------------
    # a full cache evicts its LRU entry for a new promotion only when that
    # entry has not served within the freshness window, measured in the
    # bucket's dispatches and scaled with its fleet (uniform round-robin over
    # M machines touches each entry every ~M dispatches); 0 disables the
    # guard (tests)
    _HOT_EVICT_AFTER = 64

    def _hot_evict_window(self) -> int:
        if not self._HOT_EVICT_AFTER:
            return 0
        return max(self._HOT_EVICT_AFTER, 2 * len(self.names))

    @staticmethod
    def _pay_down_demotions(demotions: Dict[int, int], idx: int) -> None:
        """A successful serve pays one demotion of a machine's backoff down
        (hot or mega): a transient failure does not escalate its threshold
        for good, a machine that keeps failing never gets here. Callers
        hold the matching lock."""
        count = demotions.get(idx)
        if count:
            if count > 1:
                demotions[idx] = count - 1
            else:
                del demotions[idx]

    def _demote(self, idx: int) -> None:
        with self._hot_lock:
            lockcheck.assert_guard("engine.hot")
            self._hot.pop(idx, None)
            self._hot_last_use.pop(idx, None)
            self._hot_hits.pop(idx, None)
            self._hot_demotions[idx] = self._hot_demotions.get(idx, 0) + 1
        _M_HOT_EVENTS.labels("demote").inc()

    def _maybe_promote(self, items: List[_Item]) -> None:
        """After a successful cold dispatch (shard mode): a machine's second
        cold hit gets it a hot copy (``2·8^demotions`` hits after
        demotions); a full cache evicts its LRU entry unless that entry is
        fresh. The gather runs outside the hot lock (under the shard lock,
        see _gather_machine)."""
        if not self._hot_cap:
            return
        for idx in {it.idx for it in items}:
            with self._hot_lock:
                if idx in self._hot:
                    # served through a mixed (cold) batch: its traffic is live
                    self._hot.move_to_end(idx)
                    self._hot_last_use[idx] = self.dispatch_count
                    continue
                hits = self._hot_hits.get(idx, 0) + 1
                self._hot_hits[idx] = hits
                if hits < 2 * (8 ** self._hot_demotions.get(idx, 0)):
                    if self._hot_demotions.get(idx):
                        _M_HOT_EVENTS.labels("backoff_defer").inc()
                    continue
                if len(self._hot) >= self._hot_cap:
                    victim = next(iter(self._hot))
                    age = self.dispatch_count - self._hot_last_use.get(victim, 0)
                    if age < self._hot_evict_window():
                        continue  # the working set is live: do not thrash it
                    self._hot.pop(victim)
                    self._hot_last_use.pop(victim, None)
                    # an evicted machine re-earns its promotion from zero
                    self._hot_hits.pop(victim, None)
                    _M_HOT_EVENTS.labels("evict").inc()
            tree = self._gather_machine(idx)
            with self._hot_lock:
                lockcheck.assert_guard("engine.hot")
                self._hot[idx] = tree
                self._hot_last_use[idx] = self.dispatch_count
            _M_HOT_EVENTS.labels("promote").inc()

    def _mega_demote(self, idx: int) -> None:
        """Take a machine out of megabatch residency (its fused serve
        failed): its traffic routes cold and re-earns a slot under
        backoff."""
        with self._mega_lock:
            lockcheck.assert_guard("engine.mega")
            if idx not in self._mega_slots:
                return
            del self._mega_slots[idx]
            self._mega_last_use.pop(idx, None)
            self._mega_hits.pop(idx, None)
            self._mega_demotions[idx] = self._mega_demotions.get(idx, 0) + 1
        _M_MEGA_EVENTS.labels("demote").inc()
        spans.event("megabatch_residency", action="demote",
                    machine=self.names[idx] if idx < len(self.names) else idx)

    def _maybe_promote_mega(self, items: List[_Item]) -> None:
        """After a successful cold dispatch: megabatch residency, the hot
        cache's policy with the reference's counts. A machine is admitted on
        its second cold hit (``2·8^demotions`` after demotions); a partial
        bucket at its cap evicts its stale, unpinned LRU resident first. A
        full bucket only re-admits machines demoted by failures. Admission
        moves no bytes: a slot is the machine's own row of the stack."""
        if not self._mega_enabled:
            return
        for idx in {it.idx for it in items}:
            with self._mega_lock:
                lockcheck.assert_guard("engine.mega")
                if idx in self._mega_slots:
                    # a resident machine served through a mixed cold batch
                    self._mega_slots.move_to_end(idx)
                    self._mega_last_use[idx] = self.dispatch_count
                    continue
                hits = self._mega_hits.get(idx, 0) + 1
                self._mega_hits[idx] = hits
                if hits < 2 * (8 ** self._mega_demotions.get(idx, 0)):
                    if self._mega_demotions.get(idx):
                        _M_MEGA_EVENTS.labels("backoff_defer").inc()
                    continue
                if not self._mega_full and len(self._mega_slots) >= self._mega_cap:
                    # the LRU victim, skipping the plan's pinned residents
                    victim = next((v for v in self._mega_slots if v not in self._mega_pinned),
                                  None)
                    if victim is None:
                        continue  # every slot is pinned: stay cold
                    age = self.dispatch_count - self._mega_last_use.get(victim, 0)
                    if age < self._hot_evict_window() and idx not in self._mega_pinned:
                        continue  # the working set is live: do not thrash it
                    del self._mega_slots[victim]
                    self._mega_last_use.pop(victim, None)
                    self._mega_hits.pop(victim, None)
                    _M_MEGA_EVENTS.labels("evict").inc()
                    spans.event("megabatch_residency", action="evict",
                                machine=self.names[victim])
                self._mega_slots[idx] = None
                self._mega_last_use[idx] = self.dispatch_count
                self._mega_hits.pop(idx, None)
            _M_MEGA_EVENTS.labels("promote").inc()
            spans.event("megabatch_residency", action="promote", machine=self.names[idx])

    # -- live tuning and accounting --------------------------------------------
    def set_dispatch_depth(self, depth: int) -> int:
        depth = max(1, int(depth))
        self.dispatch_depth = depth
        return self._inflight_slots.resize(depth)

    def set_fill_window(self, seconds: float) -> float:
        """Retarget the fill window live; off for a bucket that never
        megabatches, the constructor's rule."""
        self._fill_s = max(0.0, float(seconds)) if self._mega_enabled else 0.0
        return self._fill_s

    def set_mega_cap(self, cap: int) -> Optional[int]:
        """Retarget a partial bucket's residency cap live; None for a full
        (or non-megabatching) bucket, which has no cap to turn. A resize
        resets residency and the mega path's shapes, as the reference's
        (whose resident stack's height is the cap): machines re-earn their
        slots by the promotion path."""
        if not self._mega_enabled or self._mega_full:
            return None
        cap = max(1, int(cap))
        with self._mega_lock:
            lockcheck.assert_guard("engine.mega")
            if cap == self._mega_cap:
                return cap
            self._mega_cap = cap
            self._mega_slots.clear()
            self._mega_hits.clear()
            self._mega_last_use.clear()
        self._programs = {key for key in self._programs if key[0] != "mega"}
        _M_MEGA_EVENTS.labels("residency_resize").inc()
        spans.event("megabatch_residency", action="resize", cap=cap)
        return cap

    def pin_mega(self, idxs: Iterable[int]) -> Dict[str, int]:
        """Install the layout plan's pins for this bucket, REPLACING the
        previous set (``()`` clears it). A pin does no stack work: a pinned
        machine that is not resident gets its hit counter seeded to one
        below its threshold, so its next cold hit promotes it, and eviction
        skips pinned residents. A full bucket only records the set."""
        valid = {int(idx) for idx in idxs if 0 <= int(idx) < len(self.names)}
        seeded = 0
        with self._mega_lock:
            lockcheck.assert_guard("engine.mega")
            self._mega_pinned = valid
            if not self._mega_enabled or self._mega_full:
                resident = len(valid)
            else:
                resident = 0
                for idx in sorted(valid):
                    if idx in self._mega_slots:
                        resident += 1
                        continue
                    threshold = 2 * (8 ** self._mega_demotions.get(idx, 0))
                    if self._mega_hits.get(idx, 0) < threshold - 1:
                        self._mega_hits[idx] = threshold - 1
                        seeded += 1
        return {"pinned": len(valid), "resident": resident, "seeded": seeded}

    def _account(self, k: int, path: str = "cold") -> None:
        self.dispatch_count += 1
        self.request_count += k
        if path == "hot":
            self.hot_request_count += k
        elif path == "mega":
            self.mega_dispatch_count += 1
            self.mega_request_count += k
        self.max_batch_seen = max(self.max_batch_seen, k)
        _M_REQUESTS.labels(path).inc(k)
        _M_PRECISION.labels(self.precision).inc(k)
        _M_DISPATCH_BATCH.observe(k)

    @staticmethod
    def _fill_results(items, x_tail, pred, scaled, total) -> None:
        for i, it in enumerate(items):
            m = it.m_valid
            it.result = ScoreResult(
                model_input=x_tail[i][:m],
                model_output=pred[i][:m],
                tag_anomaly_scores=scaled[i][:m],
                total_anomaly_score=total[i][:m],
            )


class ServingEngine:
    """Stacked buckets from loaded models, scored by machine name on one
    device (or, in shard mode, over the devices of ``mesh``), and the spill
    tier for machines registered lazily.

    ``models``: ``{machine_name: loaded model}`` (weights anywhere: the
    engine stacks them on the host and places one copy on ``device``). A
    machine the engine cannot lift is recorded in :attr:`skipped` with
    its reason, answers ``KeyError`` here, and has its estimators placed
    on ``device`` for the server's host path. ``target_cols``: optional
    ``{name: [input-column index of each target tag]}`` for target-subset
    machines; ``precisions``: ``{name: rung}``; ``quantized``: ``{name:
    (q_tree, scale_tree)}``, int8 machines' stored sidecars
    (``precision.load_quantized``). ``fill_window_us`` defaults to
    ``GORDO_FILL_WINDOW_US``. ``lazy``: ``{name: loader}``, machines
    served through the spill tier; ``loader()`` returns ``{"model",
    "target_cols", "precision", "quantized", "context", "nbytes"}``
    (``context`` is the caller's and rides in the bundle; ``nbytes`` is
    the artifact's size, counted in the cache's byte ledger beside the
    tree). ``host_cache_mb`` defaults to ``GORDO_HOST_CACHE_MB`` (256).
    ``compile_cache``: the :class:`~..compile_cache.CompileCacheStore` the
    kernel libraries resolve through (None: the package's build directory).
    ``mesh_shard``: ``(shard, shards)`` when the engine is one shard of a
    fleet-sharded serving mesh, and ``mesh_remote`` the lazy machines other
    shards own: requests count in ``gordo_mesh_requests_total`` by rung
    (``owned``, or ``fallback`` with a ``mesh_fallback`` span event).
    ``mesh``: a :func:`~..parallel.mesh.fleet_mesh` device list, the
    host-sharded capacity mode (each bucket's stack split over its devices,
    scored on its first, which is the engine's device; megabatching off);
    ``hot_cap`` (default ``GORDO_SERVE_HOT_CACHE``, 16) bounds its hot
    cache per bucket. ``megabatch`` (default ``GORDO_MEGABATCH``, on) and
    ``megabatch_residency`` (default ``GORDO_MEGABATCH_RESIDENCY``, 128):
    the replicated engine's fused path and its resident machines per
    bucket (see the module docstring).
    """

    def __init__(
        self,
        models: Dict[str, Any],
        max_batch: int = 64,
        min_rows_bucket: int = 64,
        max_rows_dispatch: int = 8192,
        target_cols: Optional[Dict[str, Optional[List[int]]]] = None,
        fill_window_us: Optional[int] = None,
        precisions: Optional[Dict[str, str]] = None,
        quantized: Optional[Dict[str, Tuple[Any, Any]]] = None,
        device: DeviceLike = None,
        lazy: Optional[Dict[str, Callable[[], Dict[str, Any]]]] = None,
        host_cache_mb: Optional[int] = None,
        compile_cache: Any = None,
        mesh_shard: Optional[Tuple[int, int]] = None,
        mesh_remote: Optional[Iterable[str]] = None,
        mesh: Optional[List[torch.device]] = None,
        hot_cap: Optional[int] = None,
        megabatch: Optional[bool] = None,
        megabatch_residency: Optional[int] = None,
    ):
        # shard mode: the stacks spread over ``mesh`` and dispatch on its
        # first device, which is the engine's
        self.mesh = list(mesh) if mesh else None
        if self.mesh is not None:
            first = self.mesh[0]
            given = resolve_device(device) if device is not None else first
            # "cuda" names the current card, which is index 0 of the mesh
            if (given.type, given.index or 0) != (first.type, first.index or 0):
                raise ValueError(f"device {device} is not the mesh's first device {first}")
            device = first
        self.device = resolve_device(device)
        # ``(shard_id, n_shards)`` when this engine is one shard of a
        # fleet-sharded serving mesh: its eager ``models`` are the machines
        # the shard plan's ring assigns here, and the other shards'
        # machines are ``lazy``, reachable through the spill tier as the
        # fallback rung. An accounting tag only: the data plane is the
        # single-host engine over the owned subset.
        self.mesh_shard = (
            (int(mesh_shard[0]), int(mesh_shard[1])) if mesh_shard is not None else None
        )
        # the machines OTHER shards own (served here only through the
        # fallback rung); an owned machine that is lazy (an index boot) is
        # not in it: the owner is serving it
        self.mesh_remote = frozenset(mesh_remote or ())
        # the kernel-library store (compile_cache.CompileCacheStore) this
        # engine resolves its libraries through; None: the build directory
        self.compile_cache = compile_cache
        # library -> what resolving it took (hit, miss, stale, invalid,
        # loaded, built, cached): the libraries this engine launches
        self.kernel_libraries: Dict[str, str] = {}
        # the libraries the eager host-path machines' estimators launch
        self._host_path_libraries: set = set()
        # cross-machine megabatching: replicated engines only, and the fill
        # window exists for it (0 without it)
        if megabatch is None:
            megabatch = _megabatch_enabled()
        if megabatch_residency is None:
            megabatch_residency = _megabatch_residency_cap()
        if fill_window_us is None:
            fill_window_us = _fill_window_us()
        self.megabatch_residency = max(0, int(megabatch_residency))
        self.megabatch = bool(megabatch) and self.mesh is None and self.megabatch_residency > 0
        self.fill_window_us = max(0, int(fill_window_us)) if self.megabatch else 0
        # shard mode's hot cache per bucket (0 disables; a replicated engine
        # has no gather to skip and ignores it)
        if hot_cap is None:
            hot_cap = _env_int("GORDO_SERVE_HOT_CACHE", 16)
        self.hot_cap = max(0, int(hot_cap))
        self.max_batch = max_batch
        self.min_rows_bucket = min_rows_bucket
        # requests longer than this score in overlapping chunks
        self.max_rows_dispatch = max_rows_dispatch
        self._by_name: Dict[str, Tuple[_Bucket, int]] = {}
        self._buckets: List[_Bucket] = []
        self.skipped: Dict[str, str] = {}
        target_cols = target_cols or {}
        precisions = precisions or {}
        quantized = quantized or {}
        # the spill tier: lazy machines hold no stacked slot and no device
        # bytes until a request loads their bundle through the host cache
        if host_cache_mb is None:
            host_cache_mb = _env_int("GORDO_HOST_CACHE_MB", 256)
        self.host_cache_mb = host_cache_mb
        self._lazy: Dict[str, Callable[[], Dict[str, Any]]] = dict(lazy or {})
        self.host_cache = HostTierCache(host_cache_mb << 20)
        # one scorer per architecture signature (O(architectures), never
        # O(machines)); two racing first builds keep the first
        self._spill_scorers: Dict[str, _SpillScorer] = {}
        # the layout plan's resident set (pin_residency)
        self.residency_pins: Tuple[str, ...] = ()
        # lazy machines whose bundle could not be lifted: name -> reason
        self._host_only: Dict[str, str] = {}
        # the cost ledger's spill seconds and requests by rung (a bucket
        # keeps its own); GIL-atomic updates, a lost race drops one sample
        self._spill_dispatch_seconds: Dict[str, float] = {}
        self._spill_request_counts: Dict[str, int] = {}

        groups: Dict[str, List[Tuple[Any, _MachineEntry]]] = {}
        for name, model in models.items():
            try:
                est, sig, entry = _lift_machine(
                    name, model, target_cols.get(name), precisions.get(name),
                    quantized.get(name),
                )
            except (ValueError, AttributeError, TypeError) as exc:
                logger.info("Serving engine skips %r: %s", name, exc)
                self.skipped[name] = str(exc)
                self._host_path_libraries.update(self._place_for_host_path(model))
                continue
            groups.setdefault(sig, []).append((est, entry))

        for sig, members in sorted(groups.items()):
            est0 = members[0][0]
            bucket = _Bucket(
                template=_meta_template(est0.module_),
                lookback=est0.lookback_window,
                lookahead=est0.lookahead,
                entries=[entry for _, entry in members],
                max_batch=max_batch,
                device=self.device,
                fill_window_s=self.fill_window_us / 1e6,
                precision=json.loads(sig)["precision"],
                mesh=self.mesh,
                hot_cap=self.hot_cap,
                megabatch=self.megabatch,
                mega_cap=self.megabatch_residency,
            )
            self._buckets.append(bucket)
            for i, (_, entry) in enumerate(members):
                self._by_name[entry.name] = (bucket, i)
        if self._by_name:
            logger.info(
                "Serving engine: %d machine(s) in %d bucket(s) on %s",
                len(self._by_name), len(self._buckets), self.device,
            )
        # last-write-wins gauges: a reload's new engine overwrites the old
        # one's values
        REGISTRY.gauge(
            "gordo_engine_machines",
            "Machines lifted into the stacked serving engine",
        ).set(len(self._by_name))
        REGISTRY.gauge(
            "gordo_engine_buckets",
            "Architecture buckets (one stacked pytree + program set each)",
        ).set(len(self._buckets))
        REGISTRY.gauge(
            "gordo_engine_host_path_machines",
            "Machines the engine could not lift (serving via the slow host "
            "path; see /metrics JSON engine.host_path_machines for reasons)",
        ).set(len(self.skipped))
        if self.mesh_shard is not None:
            _M_MESH_MACHINES.labels(str(self.mesh_shard[0])).set(len(self._by_name))

    def _place_for_host_path(self, model: Any) -> List[str]:
        """A machine the engine cannot lift is scored by the server's host
        path (``model.anomaly`` / ``model.predict``): its estimators go to
        the engine's device once, here, so that path runs on the card and
        never quietly on the CPU. Its transformers stay numpy. Returns the
        kernel libraries its estimators launch there."""
        names = set()
        for est in estimators(model):
            est.to(self.device)
            if est.module_ is not None:
                names.update(_kernels.libraries_for(est.module_))
        return sorted(names)

    # -- public API --------------------------------------------------------------
    def required_libraries(self) -> List[str]:
        """The kernel libraries the eager machines launch on the card: the
        buckets' and the host-path machines' (a dense or LSTM fleet
        launches none)."""
        return sorted({name for bucket in self._buckets for name in bucket.libraries}
                      | self._host_path_libraries)

    def _resolve_kernels(self, names: List[str]) -> None:
        """Load ``names`` through the engine's store before they first run
        on the card (on the CPU no kernel launches: nothing is resolved)."""
        names = [name for name in names if name not in self.kernel_libraries]
        if names and self.device.type == "cuda":
            # a racing resolve of the same library reports "loaded": the
            # first outcome is the one that says what resolving it took
            for name, outcome in _kernels.resolve(names, self.compile_cache).items():
                self.kernel_libraries.setdefault(name, outcome)

    def warmup(self, rows: Optional[int] = None) -> int:
        """Resolve the kernel libraries the eager machines launch, the
        buckets' and the host path's (through the compile-cache store: a
        warm store loads them with no ``nvcc``), then
        score one synthetic request per bucket before traffic arrives, which
        makes the cuBLAS handles, so the first real request pays neither;
        in shard mode one promotion gather and one hot dispatch too, and in
        a partial bucket one mega dispatch (``warmup_hot``,
        ``warmup_mega``). Returns the buckets warmed."""
        self._resolve_kernels(self.required_libraries())
        for bucket in self._buckets:
            need = bucket.lookback + (bucket.lookahead or 0)
            n = max(rows or 0, need, 1)
            # not through anomaly(): a warm-up is no traffic to account
            self._anomaly(bucket, 0, bucket.names[0],
                          np.zeros((n, bucket.n_features), np.float32))
            padded = _round_up_pow2(n, self.min_rows_bucket)
            with torch.inference_mode():
                bucket.warmup_hot(padded, n)
                bucket.warmup_mega(padded, n)
        return len(self._buckets)

    def close(self) -> None:
        """Stop every bucket's collector thread (in-flight work drains) and
        the host cache's prefetch worker."""
        for bucket in self._buckets:
            bucket.close()
        self.host_cache.close()

    def quiesce(self) -> None:
        """Drain every bucket's fetch stage and the queued prefetches."""
        for bucket in self._buckets:
            bucket.quiesce()
        self.host_cache.quiesce()

    def current_tuning(self) -> Dict[str, int]:
        return {
            "dispatch_depth": (
                self._buckets[0].dispatch_depth if self._buckets else _dispatch_depth()
            ),
            "fill_window_us": self.fill_window_us,
            "megabatch_residency": self.megabatch_residency,
        }

    def apply_tuning(
        self,
        dispatch_depth: Optional[int] = None,
        fill_window_us: Optional[int] = None,
        megabatch_residency: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Retarget the data-plane knobs of a running engine (the autopilot's
        seam); returns what was applied. The fill window stays 0 on an
        engine that does not megabatch; a residency value resets the partial
        buckets' residency at the new cap and answers it, or None when no
        bucket is partial (nothing to turn)."""
        applied: Dict[str, Any] = {}
        if dispatch_depth is not None:
            depth = max(1, int(dispatch_depth))
            for bucket in self._buckets:
                bucket.set_dispatch_depth(depth)
            applied["dispatch_depth"] = depth
        if fill_window_us is not None:
            us = max(0, int(fill_window_us)) if self.megabatch else 0
            self.fill_window_us = us
            for bucket in self._buckets:
                bucket.set_fill_window(us / 1e6)
            applied["fill_window_us"] = us
        if megabatch_residency is not None:
            cap = max(1, int(megabatch_residency))
            results = [bucket.set_mega_cap(cap) for bucket in self._buckets]
            if any(result is not None for result in results):
                self.megabatch_residency = cap
                applied["megabatch_residency"] = cap
            else:
                applied["megabatch_residency"] = None
        return applied

    def pin_residency(self, names: Iterable[str]) -> Dict[str, Any]:
        """Install a layout plan's resident set, REPLACING the previous one
        (``pin_residency(())`` clears it): each name's bucket gets its pins
        (``_Bucket.pin_mega``; a bucket with no planned name is cleared).
        ``resident`` counts the pinned machines resident now, ``seeded`` the
        ones whose next cold hit promotes them. Names the engine does not
        serve eagerly (lazy machines, typos, machines gone from the store)
        are reported in ``unknown``, never fatal: the plan degrades."""
        per_bucket: Dict[int, List[int]] = {}
        unknown: List[str] = []
        pinned_names = set()
        for name in names:
            entry = self._by_name.get(name)
            if entry is None:
                unknown.append(name)
                continue
            bucket, idx = entry
            per_bucket.setdefault(id(bucket), []).append(idx)
            pinned_names.add(name)
        self.residency_pins = tuple(sorted(pinned_names))
        pinned = resident = seeded = 0
        for bucket in self._buckets:
            result = bucket.pin_mega(per_bucket.get(id(bucket), ()))
            pinned += result["pinned"]
            resident += result["resident"]
            seeded += result["seeded"]
        return {"pinned": pinned, "resident": resident, "seeded": seeded,
                "unknown": sorted(unknown)}

    def can_score(self, name: str) -> bool:
        return name in self._by_name or name in self._lazy

    def machines(self) -> List[str]:
        return sorted(set(self._by_name) | set(self._lazy))

    # -- the spill tier ----------------------------------------------------------
    def has_lazy(self, name: str) -> bool:
        return name in self._lazy

    def lazy_machines(self) -> List[str]:
        return sorted(self._lazy)

    def spill_bundle(self, name: str) -> Dict[str, Any]:
        """The machine's spill bundle (host tree, scorer and the loader's
        context) from the host cache, or on a miss through the store path
        (:meth:`_build_bundle`). Store errors propagate typed: the server
        quarantines on them."""
        loader = self._lazy.get(name)
        if loader is None:
            raise KeyError(f"machine {name!r} is not registered lazy")
        return self.host_cache.get_or_load(name, lambda: self._build_bundle(name, loader))

    def _build_bundle(self, name: str, loader) -> Tuple[Dict[str, Any], int]:
        """The store path: the loader (verify, deserialise), the lift, the
        host tree (pinned on a CUDA engine) and the architecture's scorer.
        Returns ``(bundle, nbytes)`` for the cache's byte ledger: the tree's
        bytes plus the loader's artifact-size hint, which stands for the
        host copy of the model parked in the context."""
        loaded = loader()
        context_nbytes = int(loaded.get("nbytes") or 0)
        try:
            est, sig, entry = _lift_machine(
                name, loaded["model"], loaded.get("target_cols"), loaded.get("precision"),
                loaded.get("quantized"),
            )
        except (ValueError, AttributeError, TypeError) as exc:
            # the eager boot's skip rule: the host path serves it, with its
            # estimators on this engine's device; the bundle still caches
            # (the deserialisation is the expensive part either way)
            logger.info("Spill tier serves %r on the host path only: %s", name, exc)
            self._resolve_kernels(self._place_for_host_path(loaded["model"]))
            self._host_only[name] = str(exc)
            bundle = {"entry": None, "sig": None, "scorer": None, "skip": str(exc),
                      "context": loaded.get("context")}
            return bundle, context_nbytes
        self._host_only.pop(name, None)
        scorer = self._spill_scorers.get(sig) or self._spill_scorers.setdefault(
            sig, _SpillScorer(est, json.loads(sig)["precision"], self.device))
        # a lazy machine's libraries are known at its first load
        self._resolve_kernels(_kernels.libraries_for(scorer.template))
        tree = _entry_host_tree(entry, self.device)
        bundle = {"entry": tree, "sig": sig, "scorer": scorer,
                  "context": loaded.get("context")}
        return bundle, _tree_nbytes(tree) + context_nbytes

    def prefetch(self, names: List[str]) -> Dict[str, int]:
        """A placement hint: queue background loads of the lazy machines
        expected here. Unknown and eager names are counted, never loaded;
        a hint for a machine cached or in flight is skipped."""
        queued = skipped = unknown = 0
        for name in names:
            loader = self._lazy.get(name)
            if loader is None:
                unknown += 1
                continue
            if self.host_cache.prefetch(
                name, lambda name=name, loader=loader: self._build_bundle(name, loader)
            ):
                queued += 1
            else:
                skipped += 1
        return {"queued": queued, "skipped": skipped, "unknown": unknown}

    # -- scoring -----------------------------------------------------------------
    def _prepare(self, shape, X: np.ndarray) -> Tuple[np.ndarray, int]:
        """``X`` padded to its row bucket, and its scored row count.
        ``shape``: what the rule reads, ``lookback``, ``lookahead`` and
        ``n_features`` (a bucket or a spill scorer)."""
        X = np.asarray(getattr(X, "values", X), np.float32)
        if X.ndim == 1:
            X = X[None, :]
        if X.shape[1] != shape.n_features:
            raise ValueError(f"Model expects {shape.n_features} features, got {X.shape[1]}")
        n = X.shape[0]
        L, la = shape.lookback, shape.lookahead
        if la is None:
            m_valid = n
        else:
            m_valid = windowing.n_windows(n, L, la)
            if m_valid <= 0:
                raise ValueError(
                    f"Need at least lookback_window+lookahead={L + la} rows, got {n}"
                )
        rows = _round_up_pow2(n, self.min_rows_bucket)
        if rows != n:
            X = np.concatenate([X, np.zeros((rows - n, X.shape[1]), np.float32)])
        return X, m_valid

    def anomaly(self, name: str, X) -> ScoreResult:
        """Full anomaly scoring on the engine's device, through the
        machine's bucket or, for a lazy machine, the spill tier. Requests
        longer than ``max_rows_dispatch`` rows score in overlapping
        chunks."""
        resolved = self._by_name.get(name)
        if resolved is None:
            if name in self._lazy:
                return self._anomaly_spill(name, X)
            raise KeyError(name)
        bucket, idx = resolved
        # one note per request (not per chunk or dispatch), under the
        # serving bucket's shape and rung
        traffic_accounting.note(name, bucket=bucket.shape_key, precision=bucket.precision)
        if self.mesh_shard is not None:
            # this shard owns the machine: the steady-state rung
            _M_MESH_REQUESTS.labels(str(self.mesh_shard[0]), "owned").inc()
        return self._anomaly(bucket, idx, name, X)

    def _anomaly(self, bucket: _Bucket, idx: int, name: str, X) -> ScoreResult:
        # the resilience seams, no-ops in the common case: expired work must
        # not queue behind the bucket's leader latch (the 504 path), and the
        # fault harness injects latency, errors or corruption here, the
        # boundary a real device hang would hit; staged as "dispatch" so a
        # stall here shows in the request's timeline
        with spans.stage("dispatch", machine=name):
            deadline.check("engine.dispatch")
            faults.inject("engine-dispatch", name)
            X = faults.corrupt("engine-dispatch", name, X)
        # a library's first use builds or loads it: here, on the request's
        # thread, never under the bucket's template lock (a no-op once the
        # warm-up or an earlier request resolved it)
        self._resolve_kernels(bucket.libraries)
        return self._chunked_score(
            bucket, X, lambda x_padded, m_valid: bucket.submit(idx, x_padded, m_valid)
        )

    def _anomaly_spill(self, name: str, X) -> ScoreResult:
        """A lazy machine through the spill tier: the bundle (a cache hit,
        or the store path first), then per chunk one copy of its tree to
        the device and one unbatched dispatch. The seams, the chunking rule
        and the scoring closure are the stacked path's."""
        with spans.stage("dispatch", machine=name):
            deadline.check("engine.dispatch")
            faults.inject("engine-dispatch", name)
            X = faults.corrupt("engine-dispatch", name, X)
        if self.mesh_shard is not None:
            shard = self.mesh_shard[0]
            if name in self.mesh_remote:
                # the fallback rung: another shard owns this machine and it
                # is served here (its owner is down, or the router chose
                # this worker), so say so in the series and the timeline
                _M_MESH_REQUESTS.labels(str(shard), "fallback").inc()
                spans.event("mesh_fallback", machine=name, shard=shard)
            else:
                # this shard's own machine through the spill tier (a lazy
                # boot): the owner is serving it
                _M_MESH_REQUESTS.labels(str(shard), "owned").inc()
        bundle = self.spill_bundle(name)
        scorer: Optional[_SpillScorer] = bundle["scorer"]
        if scorer is None:
            raise SpillNotLiftable(bundle.get("skip") or name)
        traffic_accounting.note(name, bucket="spill", precision=scorer.precision)
        return self._chunked_score(
            scorer, X, lambda x_padded, m_valid: self._spill_score_once(
                name, bundle, scorer, x_padded, m_valid),
        )

    def _spill_score_once(self, name: str, bundle: Dict[str, Any], scorer: _SpillScorer,
                          x_padded: np.ndarray, m_valid: int) -> ScoreResult:
        started = time.perf_counter()
        with spans.stage("dispatch", path="spill", machine=name), nan_guard():
            # the copy the spill tier exists for: one machine's tree to the
            # device, instead of a disk read and a deserialisation
            outputs = scorer.enqueue(bundle["entry"], x_padded, m_valid)
        with spans.stage("fetch", path="spill"):
            x_tail, pred, scaled, total = _Bucket._host(outputs)
        elapsed = time.perf_counter() - started
        rung = scorer.precision
        _M_DISPATCH_SECONDS.labels("spill").observe(elapsed)
        _M_REQUESTS.labels("spill").inc()
        _M_PRECISION.labels(rung).inc()
        self._spill_dispatch_seconds[rung] = self._spill_dispatch_seconds.get(rung, 0.0) + elapsed
        self._spill_request_counts[rung] = self._spill_request_counts.get(rung, 0) + 1
        return ScoreResult(
            model_input=x_tail[:m_valid],
            model_output=pred[:m_valid],
            tag_anomaly_scores=scaled[:m_valid],
            total_anomaly_score=total[:m_valid],
        )

    def _chunked_score(self, shape, X, score_chunk) -> ScoreResult:
        """THE chunk-and-stitch rule of both paths (``shape``: a bucket or a
        spill scorer, read for its lookback, lookahead and width): for a
        windowed model chunk c+1 starts ``offset`` rows before chunk c ends,
        so its first prediction row is exactly one past chunk c's last — no
        gap, no duplicate."""
        X = np.asarray(getattr(X, "values", X), np.float32)
        if X.ndim == 1:
            X = X[None, :]
        cap = self.max_rows_dispatch
        if X.shape[0] <= cap:
            deadline.check("engine.dispatch")
            x_padded, m_valid = self._prepare(shape, X)
            return score_chunk(x_padded, m_valid)
        L, la = shape.lookback, shape.lookahead
        offset = 0 if la is None else L - 1 + la
        if cap <= offset:
            raise ValueError(
                f"max_rows_dispatch ({cap}) must exceed the windowing offset ({offset})"
            )
        parts = []
        start = 0
        n = X.shape[0]
        while start < n:
            # a deadline that expires mid-backfill stops after this chunk
            deadline.check("engine.dispatch_chunk")
            chunk = X[start : start + cap]
            if len(chunk) <= offset:  # fully covered by the previous chunk
                break
            x_padded, m_valid = self._prepare(shape, chunk)
            parts.append(score_chunk(x_padded, m_valid))
            start += cap - offset
        return ScoreResult(*(np.concatenate(field) for field in zip(*parts)))

    def predict(self, name: str, X) -> np.ndarray:
        """Raw-unit predictions (the /prediction payload)."""
        return self.anomaly(name, X).model_output

    def host_path_machines(self) -> Dict[str, str]:
        """Machines scored on the server's host path, with the reason: the
        eager ones the engine skipped and the lazy ones whose bundle could
        not be lifted."""
        return dict(sorted({**self._host_only, **self.skipped}.items()))

    def stats(self) -> Dict[str, Any]:
        buckets = self._buckets
        dispatches = sum(b.dispatch_count for b in buckets)
        requests = sum(b.request_count for b in buckets)
        prec_machines: Dict[str, int] = {}
        prec_requests: Dict[str, int] = {}
        by_shape: Dict[str, Dict[str, int]] = {}
        spill_by_shape: Dict[str, int] = {}
        for scorer in list(self._spill_scorers.values()):
            key = f"{scorer.shape_key}/{_compute_dtype(scorer.template)}"
            spill_by_shape[key] = spill_by_shape.get(key, 0) + scorer.dispatch_count
        for b in buckets:
            prec_machines[b.precision] = prec_machines.get(b.precision, 0) + len(b.names)
            prec_requests[b.precision] = prec_requests.get(b.precision, 0) + b.request_count
            counts = by_shape.setdefault(f"{b.shape_key}/{_compute_dtype(b.template)}",
                                         {"dispatches": 0, "requests": 0})
            counts["dispatches"] += b.dispatch_count + b.warm_dispatch_count
            counts["requests"] += b.request_count
        mega_dispatches = sum(b.mega_dispatch_count for b in buckets)
        mega_requests = sum(b.mega_request_count for b in buckets)
        return {
            "machines": len(self._by_name),
            "buckets": len(buckets),
            # the (path, rows, k) shapes the buckets ran: the reference's
            # compiled programs (an eager program compiles nothing)
            "compiled_programs": sum(len(b._programs) for b in buckets),
            "dispatches": dispatches,
            "batched_requests": requests,
            "max_dispatch_batch": max((b.max_batch_seen for b in buckets), default=0),
            # dispatches (warm-up included) and requests by bucket shape and
            # compute dtype, so a caller outside the process can tie kernel
            # launches to the buckets that made them
            "bucket_dispatches": dict(sorted(by_shape.items())),
            # machines scored on the host path, with the reason
            "host_path_machines": self.host_path_machines(),
            "dispatch_depth": buckets[0].dispatch_depth if buckets else 0,
            # 0: replicated; else the devices each bucket's stack is split
            # over (shard mode)
            "shard_mesh_devices": len(self.mesh) if self.mesh else 0,
            # shard mode's hot cache: machines holding a copy, and the
            # requests it served
            "hot_machines": sum(len(b._hot) for b in buckets),  # lint: allow-unguarded(point-in-time len() for stats; GIL-atomic read and staleness is fine in a gauge)
            "hot_requests": sum(b.hot_request_count for b in buckets),
            # the mega path's share: its dispatches and requests, the
            # resident machines, how fill windows closed, its repairs
            "megabatch": {
                "enabled": self.megabatch,
                "fill_window_us": self.fill_window_us,
                "residency_cap": self.megabatch_residency,
                "resident_machines": sum(len(b._mega_slots) for b in buckets),  # lint: allow-unguarded(point-in-time len() for stats; GIL-atomic read and staleness is fine in a gauge)
                "dispatches": mega_dispatches,
                "requests": mega_requests,
                "fusion_ratio": (round(mega_requests / mega_dispatches, 3)
                                 if mega_dispatches else None),
                "fill_timeout_total": sum(b.fill_timeout_count for b in buckets),
                "fill_size_total": sum(b.fill_size_count for b in buckets),
                "fallback_cold": sum(b.fallback_cold_count for b in buckets),
                "retry_isolated": sum(b.retry_isolated_count for b in buckets),
            },
            "precision": {
                "machines": dict(sorted(prec_machines.items())),
                "requests": dict(sorted(prec_requests.items())),
            },
            # the kernel-library store's lookup and write counts (None: no
            # store, the build directory), and what resolving each library
            # this engine launches took
            "compile_cache": (
                dict(self.compile_cache.counters) if self.compile_cache is not None else None
            ),
            "kernel_libraries": dict(sorted(self.kernel_libraries.items())),
            # the serving mesh: which shard this engine is, what it owns
            # eagerly and how many machines it serves only as the fallback
            # rung (None: single-host serving)
            "mesh": (
                {
                    "shard": self.mesh_shard[0],
                    "shards": self.mesh_shard[1],
                    "owned_machines": len(self._by_name),
                    "remote_machines": len(self.mesh_remote),
                }
                if self.mesh_shard is not None else None
            ),
            # the spill tier: lazy machines, the host cache's economy and
            # the scorers (one per architecture, never per machine)
            "spill": {
                "lazy_machines": len(self._lazy),
                "scorers": len(self._spill_scorers),
                "requests": sum(self._spill_request_counts.values()),
                # dispatches by shape and compute dtype, as bucket_dispatches
                "scorer_dispatches": dict(sorted(spill_by_shape.items())),
                "host_cache": self.host_cache.stats(),
            },
        }

    def cost_ledger(self) -> Dict[str, Any]:
        """The measured-cost sample the telemetry warehouse takes each tick:
        per rung, the machines, buckets, stacked device bytes, served
        requests and summed dispatch seconds of the buckets and the spill
        tier (the reference's ``rungs`` block); the host cache's bytes,
        counters and latencies (``host_cache``); the spill tier's lazy
        machines, scorers and requests (``spill``); and the count of
        machines scored on the host path, eager and lazy. O(buckets +
        rungs), never O(machines)."""
        rungs: Dict[str, Dict[str, Any]] = {}

        def rung_entry(precision: str) -> Dict[str, Any]:
            return rungs.setdefault(precision, {
                "machines": 0, "buckets": 0, "device_bytes": 0, "requests": 0,
                "dispatch_seconds_total": 0.0,
            })

        for b in self._buckets:
            entry = rung_entry(b.precision)
            entry["machines"] += len(b.names)
            entry["buckets"] += 1
            entry["device_bytes"] += b.stacked_nbytes()
            entry["requests"] += b.request_count
            entry["dispatch_seconds_total"] += b.dispatch_seconds_total
        for rung, seconds in list(self._spill_dispatch_seconds.items()):
            entry = rung_entry(rung)
            entry["dispatch_seconds_total"] += seconds
            entry["requests"] += self._spill_request_counts.get(rung, 0)
        return {
            "rungs": {rung: rungs[rung] for rung in sorted(rungs)},
            "host_cache": self.host_cache.stats(),
            "spill": {
                "lazy_machines": len(self._lazy),
                "scorers": len(self._spill_scorers),
                "requests_total": sum(self._spill_request_counts.values()),
            },
            "host_path_machines": len(self.skipped) + len(self._host_only),
        }
