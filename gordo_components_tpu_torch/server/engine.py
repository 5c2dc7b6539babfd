"""Stacked multi-machine serving engine (port of
``gordo_components_tpu/server/engine.py``: the knobs at 273-349,
``ScoreResult`` … ``_make_machine_score`` at 210-253 and 352-523, the
pipeline at 611-748, ``_Bucket`` at 761-2499 and ``ServingEngine`` at
2501-3220 and its metrics at 95-190, without the mesh, hot cache, compile
cache, spill tier, spans, traffic accounting, fault injection and QoS —
ROADMAP.md lists them).

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
(``GORDO_FILL_WINDOW_US``) lets a leader that sees concurrency collect
submits across machines before its first drain; an idle request never
waits. On one device every machine of a bucket is resident from boot, so
there is no residency tier: the reference's capped resident stack and its
promotion exist for a mesh, where the fused program is replicated and
the cold one sharded (ROADMAP.md, shard mode). A fused dispatch that
fails, at enqueue or at fetch, is rescored one request per dispatch, so a
bad machine fails only its own waiters. Every dispatch, stack upload and
fetch runs on the device's current stream.

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
the port's metrics registry under the reference's series names.
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
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import precision as precision_mod
from ..models.analysis import analyze_model
from ..models.convert import quantized_params_from_flax
from ..models.transformers import MinMaxScaler, StandardScaler
from ..observability.registry import REGISTRY
from ..ops import windowing
from ..ops.scaling import ScalerParams
from ..resilience import deadline
from ..utils.backend import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

# -- engine telemetry (the reference's series; the process-wide registry,
# so a scrape survives a reload's engine swap). Every dispatch of the port
# runs the one fused program, so its path label is "mega" throughout and
# the reference's gordo_engine_megabatch_fused_requests would repeat
# gordo_engine_dispatch_batch_size.
_M_DISPATCH_BATCH = REGISTRY.histogram(
    "gordo_engine_dispatch_batch_size",
    "Requests coalesced into one device dispatch (micro-batching)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128),
)
_M_REQUESTS = REGISTRY.counter(
    "gordo_engine_requests_total",
    "Requests scored on device, by dispatch path",
    labels=("path",),
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
_M_PRECISION = REGISTRY.counter(
    "gordo_engine_precision_total",
    "Requests scored on device by the serving bucket's numeric precision "
    "(f32 / bf16 / int8)",
    labels=("precision",),
)
_M_MEGA_EVENTS = REGISTRY.counter(
    "gordo_engine_megabatch_events_total",
    "Fused-path repairs: fallback_cold (enqueue failure rescored one "
    "request per dispatch), retry_isolated (fetch failure rescored one "
    "request at a time)",
    labels=("event",),
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


def _fill_window_us() -> int:
    """``GORDO_FILL_WINDOW_US``: the fill window in microseconds; core-aware
    default (250 with 4 or more CPUs, else 1000); 0 disables the wait.
    Requests already queued when a leader drains share its dispatch either
    way, so this is the reference's ``GORDO_MEGABATCH=0`` too."""
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


# -- the pipeline (the reference's, without spans and QoS) --------------------
class _Item:
    __slots__ = ("idx", "x", "m_valid", "in_flight", "done", "result", "error")

    def __init__(self, idx: int, x: np.ndarray, m_valid: int):
        self.idx = idx
        self.x = x
        self.m_valid = m_valid
        # set (under the bucket condition) when a leader pops this item off
        # the pending queue: a woken waiter whose item is in flight must
        # wait for the collector, not elect itself leader
        self.in_flight = False
        self.done = threading.Event()
        self.result: Optional[ScoreResult] = None
        self.error: Optional[BaseException] = None


class _Dispatch:
    """One in-flight dispatch: its enqueued (not yet fetched) outputs and
    what the fetch stage needs to fan them out."""

    __slots__ = ("rows", "items", "outputs")

    def __init__(self, rows: int, items: List[_Item], outputs):
        self.rows = rows
        self.items = items
        self.outputs = outputs  # (host tensors, CUDA event or None)


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
        self._depth_cond = threading.Condition()
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
    """One architecture's stacked machines, on one device."""

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
    ):
        self.template = template
        # functional_call swaps the template's parameters for a call's
        # duration, and the program runs on leader and collector threads
        # alike: one call at a time per template
        self._template_lock = threading.Lock()
        self.device = device
        self.precision = precision  # one rung per bucket: no program mixes dtypes
        self.lookback = lookback
        self.lookahead = lookahead
        # rows a window reads past its first: window i covers rows
        # [i, i + offset]; 0 for a flat (one row per score) model
        self._offset = 0 if lookahead is None else lookback - 1 + lookahead
        self.max_batch = max_batch
        self.names = [e.name for e in entries]
        self.n_features = int(entries[0].sx.scale.shape[0])
        # stack on the host, place on the device once
        host = _tree_map(lambda *leaves: torch.stack(leaves), *[e.tree() for e in entries])
        self.stacked = _tree_map(lambda a: a.to(device), host)
        del host
        self._score = _make_machine_score(lookback, lookahead, template, precision)
        self._batched = torch.func.vmap(self._score)
        self._fill_s = max(0.0, fill_window_s)
        self._filling = False  # a leader is inside its fill window
        self.fill_timeout_count = 0
        self.fill_size_count = 0
        # fused-batch repairs, under the reference's names: a batch that
        # failed at enqueue (fallback_cold) or at fetch (retry_isolated) is
        # rescored one request per dispatch
        self.fallback_cold_count = 0
        self.retry_isolated_count = 0
        self._cond = threading.Condition()
        self._busy = False
        self._pending: Dict[int, List[_Item]] = {}
        self.dispatch_depth = _dispatch_depth()
        self._inflight_slots = _DepthGate(self.dispatch_depth)
        self._fetch_queue: "queue.Queue" = queue.Queue()
        self._collector: Optional[threading.Thread] = None
        # serializes collector handover (spawn / close / enqueue)
        self._collector_lock = threading.Lock()
        self._retiring_collector: Optional[threading.Thread] = None
        self.dispatch_count = 0
        self.request_count = 0
        self.max_batch_seen = 0

    def stacked_nbytes(self) -> int:
        """Device bytes held by this bucket's stacked tree (int8 weights
        count one byte each)."""
        return sum(a.numel() * a.element_size() for a in _tree_leaves(self.stacked))

    # -- the program -----------------------------------------------------------
    def _program(self, idxs: List[int], xs: np.ndarray):
        """The bucket's one program: machines ``idxs`` of the stack scored
        on their rows ``xs`` (k, n, F) in one dispatch; device outputs with
        a leading k axis, not yet computed. k > 1 requests run under
        ``vmap`` over the machines gathered by ``index_select``, so each
        layer is one batched kernel for all k. A lone request runs
        unbatched on views of its machine's slices: there a product keeps
        its bias in the GEMM, where under ``vmap`` each bias is its own
        pass over the activations."""
        # grad mode is thread-local, so each call enters inference mode
        with self._template_lock, torch.inference_mode():
            rows = _to_device(xs, self.device)
            if len(idxs) == 1:
                i = int(idxs[0])
                machine = _tree_map(lambda a: a[i], self.stacked)
                return tuple(t.unsqueeze(0) for t in self._score(machine, rows[0]))
            idx = _to_device(np.asarray(idxs, np.int64), self.device)
            machines = _tree_map(lambda a: a.index_select(0, idx), self.stacked)
            return self._batched(machines, rows)

    # -- request path ----------------------------------------------------------
    def submit(self, idx: int, x: np.ndarray, m_valid: int) -> ScoreResult:
        """Score one request; coalesces with concurrent requests of the
        same padded row count. One thread at a time is the leader: it
        drains the queue into dispatches, only ENQUEUES each (bounded by
        the dispatch depth), and releases the latch once the queue is
        drained or its own item completed."""
        item = _Item(idx, x, m_valid)
        rows = x.shape[0]
        is_leader = False
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
                    batches = [
                        (batch_rows, items[start : start + self.max_batch])
                        for batch_rows, items in pending.items()
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
        deadline_at = time.perf_counter() + window
        size_triggered = False
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
        if size_triggered:
            self.fill_size_count += 1
        else:
            self.fill_timeout_count += 1
        _M_FILL_TRIGGER.labels("size" if size_triggered else "timeout").inc()

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

    def _enqueue(self, idxs: List[int], xs: np.ndarray):
        """Run the program and enqueue its outputs' copy to pinned host
        memory behind it, then a CUDA event behind that; returns
        ``(host tensors, event)`` (the event is None on the CPU, where the
        work is done on return)."""
        outputs = self._program(idxs, xs)
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
        acquired = False
        try:
            xs = self._batch_inputs(items)
            self._inflight_slots.acquire()  # backpressure: bounded depth
            acquired = True
            outputs = self._enqueue([it.idx for it in items], xs)
        except Exception as exc:
            if acquired:
                self._inflight_slots.release()
            if len(items) == 1:
                self._fail(items, exc)
                return
            # one request's failure must not fail the batch's other
            # waiters: dispatch each request alone, once
            logger.exception(
                "fused dispatch of %d requests failed at enqueue; "
                "rescoring one request per dispatch", len(items),
            )
            self.fallback_cold_count += 1
            _M_MEGA_EVENTS.labels("fallback_cold").inc()
            for it in items:
                self._dispatch(rows, [it], defer)
            return
        except BaseException as exc:  # interrupt/exit: surface, don't retry
            if acquired:
                self._inflight_slots.release()
            self._fail(items, exc)
            return
        self._finish(_Dispatch(rows, items, outputs), defer)

    def _finish(self, job: _Dispatch, defer: bool) -> None:
        """Route one enqueued dispatch to its fetch stage: the collector when
        pipelining pays, else inline on the leader (the collector is then
        provably idle, so _complete stays single-threaded)."""
        if defer or self._should_pipeline():
            try:
                with self._collector_lock:
                    self._ensure_collector()
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
        out."""
        self._fetch_queue.join()

    def _fetch(self, job: _Dispatch):
        """The wait and device-to-host copy of one dispatch's outputs — a
        seam the tests fail deliberately."""
        return self._host(job.outputs)

    def _complete(self, job: _Dispatch) -> None:
        """Fetch one dispatch and fan out, errors included: an execution
        failure surfaces here, on exactly this job's waiters."""
        try:
            x_tail, pred, scaled, total = self._fetch(job)
        except Exception as exc:
            if len(job.items) > 1:
                # a fused execution is all or nothing: rescore each request
                # in its own dispatch, so one bad machine fails only its own
                # waiters
                logger.exception(
                    "fused dispatch of %d requests failed at fetch; rescoring "
                    "one request per dispatch", len(job.items),
                )
                self.retry_isolated_count += 1
                _M_MEGA_EVENTS.labels("retry_isolated").inc()
                self._retry_isolated_sync(job.items)
                return
            self._fail(job.items, exc)
            return
        except BaseException as exc:
            self._fail(job.items, exc)
            return
        try:
            # results are filled before any accounting: a fill failure
            # errors the waiters without counting them as served
            self._fill_results(job.items, x_tail, pred, scaled, total)
            self._account(len(job.items))
            _M_MEGA_MACHINES.observe(len({it.idx for it in job.items}))
        except BaseException as exc:
            for it in job.items:
                it.error = exc
        finally:
            for it in job.items:
                it.done.set()

    def _retry_isolated_sync(self, items: List[_Item]) -> None:
        """Rescore a failed fused batch ONE request at a time, synchronously
        on the collector. A sticky device fault fails each request once and
        ends the loop: nothing is retried twice."""
        for item in items:
            try:
                outputs = self._enqueue([item.idx], self._batch_inputs([item]))
                x_tail, pred, scaled, total = self._host(outputs)
                self._fill_results([item], x_tail, pred, scaled, total)
                self._account(1)
            except BaseException as exc:
                item.error = exc
            finally:
                item.done.set()

    # -- live tuning and accounting --------------------------------------------
    def set_dispatch_depth(self, depth: int) -> int:
        depth = max(1, int(depth))
        self.dispatch_depth = depth
        return self._inflight_slots.resize(depth)

    def set_fill_window(self, seconds: float) -> float:
        self._fill_s = max(0.0, float(seconds))
        return self._fill_s

    def _account(self, k: int) -> None:
        self.dispatch_count += 1
        self.request_count += k
        self.max_batch_seen = max(self.max_batch_seen, k)
        _M_REQUESTS.labels("mega").inc(k)
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
    device.

    ``models``: ``{machine_name: loaded model}`` (weights anywhere: the
    engine stacks them on the host and places one copy on ``device``). A
    machine the engine cannot lift is recorded in :attr:`skipped` with
    its reason and answers ``KeyError``. ``target_cols``: optional
    ``{name: [input-column index of each target tag]}`` for target-subset
    machines; ``precisions``: ``{name: rung}``; ``quantized``: ``{name:
    (q_tree, scale_tree)}``, int8 machines' stored sidecars
    (``precision.load_quantized``). ``fill_window_us`` defaults to
    ``GORDO_FILL_WINDOW_US``.
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
    ):
        self.device = resolve_device(device)
        if fill_window_us is None:
            fill_window_us = _fill_window_us()
        self.fill_window_us = max(0, int(fill_window_us))
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
            )
            self._buckets.append(bucket)
            for i, (_, entry) in enumerate(members):
                self._by_name[entry.name] = (bucket, i)
        if self._by_name:
            logger.info(
                "Serving engine: %d machine(s) in %d bucket(s) on %s",
                len(self._by_name), len(self._buckets), self.device,
            )

    # -- public API --------------------------------------------------------------
    def warmup(self, rows: Optional[int] = None) -> int:
        """Score one synthetic request per bucket before traffic arrives: it
        builds the CUDA kernels' libraries and the cuBLAS handles, so the
        first real request pays neither. Returns the buckets warmed."""
        for bucket in self._buckets:
            need = bucket.lookback + (bucket.lookahead or 0)
            n = max(rows or 0, need, 1)
            self.anomaly(bucket.names[0], np.zeros((n, bucket.n_features), np.float32))
        return len(self._buckets)

    def close(self) -> None:
        """Stop every bucket's collector thread (in-flight work drains)."""
        for bucket in self._buckets:
            bucket.close()

    def quiesce(self) -> None:
        for bucket in self._buckets:
            bucket.quiesce()

    def current_tuning(self) -> Dict[str, int]:
        return {
            "dispatch_depth": (
                self._buckets[0].dispatch_depth if self._buckets else _dispatch_depth()
            ),
            "fill_window_us": self.fill_window_us,
        }

    def apply_tuning(
        self,
        dispatch_depth: Optional[int] = None,
        fill_window_us: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Retarget the data-plane knobs of a running engine; returns what
        was applied."""
        applied: Dict[str, Any] = {}
        if dispatch_depth is not None:
            depth = max(1, int(dispatch_depth))
            for bucket in self._buckets:
                bucket.set_dispatch_depth(depth)
            applied["dispatch_depth"] = depth
        if fill_window_us is not None:
            us = max(0, int(fill_window_us))
            self.fill_window_us = us
            for bucket in self._buckets:
                bucket.set_fill_window(us / 1e6)
            applied["fill_window_us"] = us
        return applied

    def can_score(self, name: str) -> bool:
        return name in self._by_name

    def machines(self) -> List[str]:
        return sorted(self._by_name)

    def _prepare(self, bucket: _Bucket, X: np.ndarray) -> Tuple[np.ndarray, int]:
        X = np.asarray(getattr(X, "values", X), np.float32)
        if X.ndim == 1:
            X = X[None, :]
        if X.shape[1] != bucket.n_features:
            raise ValueError(f"Model expects {bucket.n_features} features, got {X.shape[1]}")
        n = X.shape[0]
        L, la = bucket.lookback, bucket.lookahead
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
        """Full anomaly scoring on the engine's device. Requests longer than
        ``max_rows_dispatch`` rows score in overlapping chunks."""
        resolved = self._by_name.get(name)
        if resolved is None:
            raise KeyError(name)
        bucket, idx = resolved
        # expired work must not queue behind the bucket's leader latch
        deadline.check("engine.dispatch")
        return self._chunked_score(
            bucket, X, lambda x_padded, m_valid: bucket.submit(idx, x_padded, m_valid)
        )

    def _chunked_score(self, bucket: _Bucket, X, score_chunk) -> ScoreResult:
        """THE chunk-and-stitch rule: for a windowed model chunk c+1 starts
        ``offset`` rows before chunk c ends, so its first prediction row is
        exactly one past chunk c's last — no gap, no duplicate."""
        X = np.asarray(getattr(X, "values", X), np.float32)
        if X.ndim == 1:
            X = X[None, :]
        cap = self.max_rows_dispatch
        if X.shape[0] <= cap:
            deadline.check("engine.dispatch")
            x_padded, m_valid = self._prepare(bucket, X)
            return score_chunk(x_padded, m_valid)
        L, la = bucket.lookback, bucket.lookahead
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
            x_padded, m_valid = self._prepare(bucket, chunk)
            parts.append(score_chunk(x_padded, m_valid))
            start += cap - offset
        return ScoreResult(*(np.concatenate(field) for field in zip(*parts)))

    def predict(self, name: str, X) -> np.ndarray:
        """Raw-unit predictions (the /prediction payload)."""
        return self.anomaly(name, X).model_output

    def stats(self) -> Dict[str, Any]:
        buckets = self._buckets
        dispatches = sum(b.dispatch_count for b in buckets)
        requests = sum(b.request_count for b in buckets)
        prec_machines: Dict[str, int] = {}
        prec_requests: Dict[str, int] = {}
        for b in buckets:
            prec_machines[b.precision] = prec_machines.get(b.precision, 0) + len(b.names)
            prec_requests[b.precision] = prec_requests.get(b.precision, 0) + b.request_count
        return {
            "machines": len(self._by_name),
            "buckets": len(buckets),
            "dispatches": dispatches,
            "batched_requests": requests,
            "max_dispatch_batch": max((b.max_batch_seen for b in buckets), default=0),
            # machines the engine cannot score, with the reason
            "host_path_machines": dict(sorted(self.skipped.items())),
            "dispatch_depth": buckets[0].dispatch_depth if buckets else 0,
            # every dispatch runs the one fused program, so the block's
            # counts are the engine's; the reference's block counts its
            # resident program's share
            "megabatch": {
                "fill_window_us": self.fill_window_us,
                "dispatches": dispatches,
                "requests": requests,
                "fusion_ratio": round(requests / dispatches, 3) if dispatches else None,
                "fill_timeout_total": sum(b.fill_timeout_count for b in buckets),
                "fill_size_total": sum(b.fill_size_count for b in buckets),
                "fallback_cold": sum(b.fallback_cold_count for b in buckets),
                "retry_isolated": sum(b.retry_isolated_count for b in buckets),
            },
            "precision": {
                "machines": dict(sorted(prec_machines.items())),
                "requests": dict(sorted(prec_requests.items())),
            },
        }
