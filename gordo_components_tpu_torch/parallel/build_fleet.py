"""Fleet builder: N machine configs → one stacked program per bucket →
per-machine artifacts identical to the single-machine builder's (the
port's copy of ``gordo_components_tpu/parallel/build_fleet.py:1-286,
568-845, 923-1521``, single process).

The reference's workflow emits one pod per machine running ``gordo
build``; ``build_fleet`` builds the fleet in one process instead: machines
are grouped into buckets (same model config, data widths, CV depth and
fold mode), each bucket trains as one stacked program on the card
(:func:`.fleet.train_fleet_arrays`), and every machine still gets its own
committed generation, metadata, registry entry and journal record, so the
serving layer and the idempotency cache are shared with ``gordo build``,
and a killed build resumes machine by machine.

Supported model configs (the reference's canonical anomaly shapes):

1. ``DiffBasedAnomalyDetector(base_estimator=TransformedTargetRegressor(
   regressor=Pipeline([scaler, estimator]), transformer=scaler))``
2. ``DiffBasedAnomalyDetector(base_estimator=Pipeline([scaler, estimator]))``
3. ``Pipeline([scaler, estimator])`` / a bare estimator

with a zoo estimator and ``MinMaxScaler`` / ``StandardScaler`` steps.

Not ported yet (a later slice): multi-process ranks (the reference's
multi-host branches, ``_local_machine_span``, ``_gather_local_block``, the
slice watchdog): a build inside a ``torch.distributed`` group of more than
one rank raises ``NotImplementedError``; and the orbax slice checkpointer, a resume accelerator
only: the per-machine registry and journal resume is kept.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import __version__
from .. import precision as precision_mod
from ..builder.build_model import (
    _dataset_from_config,
    cached_artifact_precision,
    calculate_model_key,
)
from ..models.analysis import Analyzed, analyze_model
from ..models.convert import flax_from_params
from ..models.transformers import MinMaxScaler, StandardScaler
from ..observability.registry import REGISTRY
from ..ops import _kernels
from ..ops.scaling import ScalerParams
from ..resilience import faults
from ..serializer import pipeline_from_definition
from ..serializer.persistence import estimators, write_artifact_files
from ..store import journal as store_journal
from ..store.errors import StoreError
from ..store.generations import commit_generation, resolve_artifact_dir
from ..store.manifest import verify_artifact
from ..utils import disk_registry
from ..utils.backend import DeviceLike
from ..utils.profiling import PhaseTimer, device_trace
from .fleet import FLEET_CV_METRICS, FleetSpec, MachineBatch, train_fleet_arrays
from .mesh import fleet_devices, pad_to_multiple

logger = logging.getLogger(__name__)

_M_FLEET_MACHINES = REGISTRY.counter(
    "gordo_fleet_machines_total",
    "Fleet-build machines resolved, by outcome (completed / cached / failed)",
    labels=("outcome",),
)
_M_BUILD_FETCH = REGISTRY.counter(
    "gordo_resilience_build_fetch_total",
    "Fleet-build per-machine data-fetch outcomes (ok / retry / failed)",
    labels=("outcome",),
)
_M_MACHINE_BUILD_SECONDS = REGISTRY.gauge(
    "gordo_fleet_machine_build_seconds",
    "Amortized build duration of each machine's latest fleet build "
    "(slice wall-clock / machines in slice)",
    labels=("machine",),
)

# sliced builds round the padded row axis up to a multiple of this, so
# slices of slightly different history share one shape
_ROW_QUANTUM = 256

MANIFEST_FILE = "fleet_manifest.json"

# per-machine data-fetch retry knobs: transient provider failures get a
# few backed-off retries; a machine that still fails is built as
# zero-weight padding and recorded failed instead of killing the others
FETCH_RETRIES_ENV = "GORDO_BUILD_FETCH_RETRIES"
FETCH_BACKOFF_ENV = "GORDO_BUILD_FETCH_BACKOFF"

_MULTI_PROCESS = ("multi-process fleet builds (a torch.distributed group of more than one rank) "
                  "are not ported yet: ROADMAP Queue 1 item 3")


def _world_size() -> int:
    """The ranks of this process's ``torch.distributed`` group (1 without
    one): the port's counterpart of ``jax.process_count()``."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _fetch_machine_data(item: dict, retries: int, backoff: float) -> Optional[str]:
    """Fetch one machine's rows into ``item`` (X, y, dataset metadata),
    retrying transient provider failures with exponential backoff. Returns
    None on success, else the terminal error. A ``ValueError`` (a bad
    config, too few rows) is permanent and is not retried."""
    name = item["machine"].name
    last_error: Optional[str] = None
    for attempt in range(max(0, retries) + 1):
        if attempt:
            _M_BUILD_FETCH.labels("retry").inc()
            time.sleep(backoff * 2 ** (attempt - 1))
        try:
            # chaos seam: `data-fetch:<machine>:error` stands in for a dead
            # source for exactly one machine
            faults.inject("data-fetch", name)
            X, y = item["dataset"].get_data()
            item["X"] = np.asarray(X, np.float32)
            item["y"] = np.asarray(y, np.float32)
            item["dataset_metadata"] = item["dataset"].get_metadata()
            _M_BUILD_FETCH.labels("ok").inc()
            return None
        except ValueError as exc:  # permanent (InsufficientDataError included)
            last_error = f"{type(exc).__name__}: {exc}"
            break
        except Exception as exc:
            last_error = f"{type(exc).__name__}: {exc}"
            logger.warning("Fleet fetch failed for %r (attempt %d/%d): %s",
                           name, attempt + 1, max(0, retries) + 1, last_error)
    _M_BUILD_FETCH.labels("failed").inc()
    return last_error


def _prepare_slice(
    slice_items: List[dict],
    n_padded: int,
    n_features: int,
    n_targets: int,
    quantize_rows: bool,
    fetch_retries: int = 2,
    fetch_backoff: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, float]:
    """Host-side ingest of one slice: the provider fetches, then the padded
    stacked arrays ``(n_padded, n_rows, ·)``. It runs on the prefetch
    worker, so slice s+1's fetch overlaps slice s's training. Rows are
    RIGHT-aligned (they end at the bucket's latest timestamp); padding rows
    and padding machines have weight 0. A machine whose fetch fails after
    its retries is built as padding and carries ``build_error``. Every
    shape is an argument, not a closure over the caller's loop."""
    started = time.perf_counter()

    def fetch_one(item: dict) -> None:
        error = _fetch_machine_data(item, fetch_retries, fetch_backoff)
        if error is not None:
            logger.error("Isolating machine %r from fleet build: %s",
                         item["machine"].name, error)
            item["build_error"] = error
            item["X"] = np.zeros((0, n_features), np.float32)
            item["y"] = np.zeros((0, n_targets), np.float32)
            item["dataset_metadata"] = {}

    to_fetch = [item for item in slice_items if "X" not in item]  # the width probe's are in
    if len(to_fetch) > 1:
        # independent, I/O-bound fetches: overlap their latency
        with ThreadPoolExecutor(max_workers=min(8, len(to_fetch)),
                                thread_name_prefix="fleet-fetch") as pool:
            list(pool.map(fetch_one, to_fetch))
    else:
        for item in to_fetch:
            fetch_one(item)
    # an all-failed slice still needs a nonzero row axis
    n_rows = max(max((len(item["X"]) for item in slice_items), default=1), 1)
    if quantize_rows:
        n_rows = -(-n_rows // _ROW_QUANTUM) * _ROW_QUANTUM
    X = np.zeros((n_padded, n_rows, n_features), np.float32)
    y = np.zeros((n_padded, n_rows, n_targets), np.float32)
    w = np.zeros((n_padded, n_rows), np.float32)
    for i, item in enumerate(slice_items):
        rows = len(item["X"])
        X[i, n_rows - rows:] = item["X"]
        y[i, n_rows - rows:] = item["y"]
        w[i, n_rows - rows:] = 1.0
    return X, y, w, n_rows, time.perf_counter() - started


def _write_manifest(
    output_dir: str,
    completed: Dict[str, Dict[str, Any]],
    pending: List[str],
    journal_counts: Optional[Dict[str, int]] = None,
) -> None:
    """The fleet's completion record, ``<output_dir>/fleet_manifest.json``,
    rewritten atomically after every slice; ``journal_counts`` is the
    resume accounting (``resumed``, ``torn``, ``rebuilt``)."""
    os.makedirs(output_dir, exist_ok=True)
    payload = {
        "updated": time.strftime("%Y-%m-%d %H:%M:%S%z"),
        "n_completed": len(completed),
        "n_pending": len(pending),
        "machines": completed,
        "pending": sorted(pending),
    }
    if journal_counts is not None:
        payload["journal"] = dict(journal_counts)
    fd, tmp = tempfile.mkstemp(dir=output_dir, suffix=".manifest")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(payload, fh, indent=2)
        os.replace(tmp, os.path.join(output_dir, MANIFEST_FILE))
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


@dataclass
class FleetMachineConfig:
    name: str
    model_config: Dict[str, Any]
    data_config: Dict[str, Any]
    metadata: Dict[str, Any] = field(default_factory=dict)
    # per-machine evaluation overrides: ``n_splits`` here beats the build's
    # default, so machines of different CV depths land in different buckets
    evaluation: Dict[str, Any] = field(default_factory=dict)


def _effective_splits(
    machine: FleetMachineConfig, default: int
) -> Tuple[int, Optional[bool], List[str]]:
    """The machine's CV depth (``evaluation.n_splits``, else ``default``),
    its fold mode (``evaluation.cv_parallel``, None to derive it) and the
    evaluation keys the fleet builder ignores (``cv_mode`` is always
    ``"fleet"`` here)."""
    evaluation = machine.evaluation or {}
    value = evaluation.get("n_splits")
    if value is None:
        eff = int(default)
    else:
        if isinstance(value, bool) or not isinstance(value, int):
            raise ValueError(f"Machine {machine.name!r}: evaluation.n_splits must be an "
                             f"integer, got {value!r}")
        if value < 0:
            raise ValueError(f"Machine {machine.name!r}: evaluation.n_splits must be >= 0, "
                             f"got {value}")
        eff = value
    cv_parallel = evaluation.get("cv_parallel")
    if cv_parallel is not None and not isinstance(cv_parallel, bool):
        raise ValueError(f"Machine {machine.name!r}: evaluation.cv_parallel must be a "
                         f"boolean, got {cv_parallel!r}")
    ignored = sorted(k for k in evaluation if k not in {"n_splits", "cv_parallel"})
    return eff, cv_parallel, ignored


def _derived_cv_parallel(model_config: Dict[str, Any]) -> bool:
    """The fold mode a config derives when ``evaluation.cv_parallel`` is
    absent: sequential iff the model asks for ``remat`` (memory-
    constrained), read off the config dict itself."""

    def scan(node: Any) -> bool:
        if isinstance(node, dict):
            return bool(node.get("remat")) or any(scan(v) for v in node.values())
        if isinstance(node, (list, tuple)):
            return any(scan(v) for v in node)
        return False

    return not scan(model_config)


def _scaler_kind(scaler: Optional[Any]) -> Tuple[str, Tuple[float, float], Tuple[bool, bool]]:
    if scaler is None:
        return "none", (0.0, 1.0), (True, True)
    if isinstance(scaler, MinMaxScaler):
        return "minmax", tuple(scaler.feature_range), (True, True)
    if isinstance(scaler, StandardScaler):
        return "standard", (0.0, 1.0), (bool(scaler.with_mean), bool(scaler.with_std))
    raise ValueError("Fleet building supports MinMaxScaler/StandardScaler steps; got "
                     f"{type(scaler).__name__}")


def _spec_for(
    analyzed: Analyzed,
    n_features: int,
    n_targets: int,
    n_splits: int,
    cv_parallel: Optional[bool] = None,
) -> FleetSpec:
    est = analyzed.estimator
    if getattr(est, "joint_horizon", False):
        raise ValueError(
            "MultiStepForecast (joint horizon) is single-machine only: the fleet program's "
            "target/weight math assumes one target row per window — use "
            "LSTMForecast(horizon=k) for fleet builds")
    model_spec = est._make_spec(n_features, n_targets)
    kind, feature_range, scaler_options = _scaler_kind(analyzed.input_scaler)
    t_kind, t_range, t_options = _scaler_kind(analyzed.target_scaler)
    if analyzed.detector is not None and not isinstance(analyzed.detector.scaler, MinMaxScaler):
        # the program fits min-max error-scaler parameters; another scaler
        # class would silently change scoring
        raise ValueError(
            "Fleet building supports a MinMaxScaler anomaly error scaler; got "
            f"{type(analyzed.detector.scaler).__name__} — use the single-machine builder "
            "for this config")
    dropout = float(model_spec.config.get("dropout", 0.0) or 0.0)
    memory_constrained = bool(model_spec.config.get("remat", False))
    if cv_parallel is None:
        # a remat config trades compute for memory already: multiplying
        # its step memory by K+1 would undo that
        cv_parallel = not memory_constrained
    return FleetSpec(
        module=model_spec.module,
        optimizer=model_spec.optimizer,
        loss=model_spec.loss,
        lookahead=est.lookahead,
        lookback_window=est.lookback_window,
        scaler=kind,
        feature_range=feature_range,
        batch_size=est.batch_size,
        epochs=est.epochs,
        n_splits=n_splits,
        use_dropout=dropout > 0.0,
        scale_targets=analyzed.target_scaler is not None,
        scaler_options=scaler_options,
        target_scaler=t_kind,
        target_feature_range=t_range,
        target_scaler_options=t_options,
        cv_parallel=cv_parallel,
        # read by nothing in eager PyTorch: derived as the reference derives
        # it only so that a spec equals the reference's field by field
        fit_unroll=1 if (memory_constrained or model_spec.input_kind == "window") else 4,
        widen_predict=not memory_constrained,
    )


def _slice_scaler(stacked: ScalerParams, i: int) -> ScalerParams:
    return ScalerParams(scale=np.asarray(stacked.scale[i], np.float32),
                        offset=np.asarray(stacked.offset[i], np.float32))


def _install_result(model: Any, result, i: int, n_features: int, n_targets: int,
                    n_splits: int) -> None:
    """Write machine ``i``'s slice of the (host) stacked result into a
    fresh model graph, giving the fitted object the single-machine path
    gives. The parameters go through the flax layout, as an artifact holds
    them."""
    analyzed = analyze_model(model)
    est = analyzed.estimator
    module = est._make_spec(n_features, n_targets).module
    module.load_state_dict({name: torch.from_numpy(np.array(leaf[i]))
                            for name, leaf in result.params.items()})
    est.set_state({
        "params": flax_from_params(module),
        "n_features": n_features,
        "n_features_out": n_targets,
        "history": [float(v) for v in np.asarray(result.loss_history[i])],
    })
    if analyzed.input_scaler is not None:
        analyzed.input_scaler.params_ = _slice_scaler(result.input_scaler, i)
    if analyzed.target_scaler is not None:
        analyzed.target_scaler.params_ = _slice_scaler(result.target_scaler, i)
    if analyzed.detector is not None:
        det = analyzed.detector
        det.scaler.params_ = _slice_scaler(result.error_scaler, i)
        det.tag_thresholds_ = np.asarray(result.tag_thresholds[i], np.float32)
        det.total_threshold_ = float(result.total_threshold[i])
        det.cross_validation_ = _cv_metadata(result, i, n_splits)


def _cv_metadata(result, i: int, n_splits: int) -> Dict[str, Any]:
    """Machine ``i``'s CV record with the single-machine builder's metric
    keys; a NaN fold score (the fold had no real rows) is null and is not
    averaged in."""
    cv_scores = np.asarray(result.cv_scores[i])  # (n_splits, n_metrics)

    def val(s):
        return float(s) if np.isfinite(s) else None

    aggregates = {}
    for m, name in enumerate(FLEET_CV_METRICS):
        real = cv_scores[:, m][np.isfinite(cv_scores[:, m])]
        aggregates[name] = float(np.mean(real)) if len(real) else None
    return {
        "n_splits": n_splits,
        "splits": [{"fold": k, "scores": {name: val(fold[m])
                                          for m, name in enumerate(FLEET_CV_METRICS)}}
                   for k, fold in enumerate(cv_scores)],
        "scores": aggregates,
    }


def machine_seeds(seed: int, bucket: int, slice_index: int, n: int) -> np.ndarray:
    """One integer key per machine of a slice, from (seed, bucket, slice,
    position): the port's counterpart of the reference's
    ``split(fold_in(fold_in(PRNGKey(seed), b), s), n)``."""
    return np.random.SeedSequence([int(seed), int(bucket), int(slice_index)]).generate_state(
        n, np.uint32).astype(np.int64)


def _to_host(result):
    """A stacked result's tensors as host numpy arrays."""
    def host(value):
        if isinstance(value, dict):
            return {k: host(v) for k, v in value.items()}
        if isinstance(value, tuple):
            return type(value)(*(host(v) for v in value))
        return value.detach().cpu().numpy() if torch.is_tensor(value) else value

    return host(result)


def build_fleet(
    machines: List[FleetMachineConfig],
    output_dir: str,
    model_register_dir: Optional[str] = None,
    device: DeviceLike = None,
    seed: int = 0,
    n_splits: int = 3,
    profile_dir: Optional[str] = None,
    slice_size: Optional[int] = 256,
    fetch_retries: Optional[int] = None,
    fetch_backoff: Optional[float] = None,
    precision_default: Optional[str] = None,
    precision_map: Optional[Dict[str, str]] = None,
    compile_cache_store: Any = None,
) -> Dict[str, str]:
    """Build every machine on ``device`` (``cuda`` unless the caller says
    ``"cpu"``); returns ``{name: model_dir}`` (a generation root under
    ``output_dir`` per machine). ``compile_cache_store``: a
    :class:`~..compile_cache.CompileCacheStore` the training's kernel
    libraries (forward and backward) resolve through.

    **Precision**: ``precision_map`` pins machines to a rung (f32 / bf16 /
    int8), the rest take ``precision_default`` (flag →
    ``GORDO_PRECISION_DEFAULT`` → f32). The rung never changes training: it
    shapes each machine's artifact (its metadata pin, the int8 sidecar)
    and its cache key.

    **Failure isolation**: a machine whose data fetch fails after
    ``fetch_retries`` backed-off retries (defaults
    ``GORDO_BUILD_FETCH_RETRIES`` / ``GORDO_BUILD_FETCH_BACKOFF``, else 2 /
    0.5 s) trains as zero-weight padding, gets no artifact and is recorded
    ``failed`` in the manifest and the journal; the next run retries it.

    **Resume**: a machine whose key is registered — or, without a
    registry, whose journal record says ``committed`` under the same key —
    is skipped once its artifact passes structural verification and pins
    the requested rung; a torn one is rebuilt and counted ``torn`` in the
    manifest's ``journal`` block (beside ``resumed`` and ``rebuilt``).

    **Slices**: a bucket larger than ``slice_size`` trains in slices of
    that many machines, each padded to the same count; a slice's
    artifacts, registry keys and journal records land as it finishes, so a
    kill loses at most the slice in flight. ``slice_size=None`` trains a
    bucket in one stack. ``profile_dir`` wraps the training in
    ``torch.profiler``. Inside a ``torch.distributed`` group of more than
    one rank it raises ``NotImplementedError``: ranks are not ported yet."""
    with _kernels.use_store(compile_cache_store):
        return _build_fleet(machines, output_dir, model_register_dir, device, seed, n_splits,
                            profile_dir, slice_size, fetch_retries, fetch_backoff,
                            precision_default, precision_map)


def _build_fleet(machines, output_dir, model_register_dir, device, seed, n_splits,
                 profile_dir, slice_size, fetch_retries, fetch_backoff,
                 precision_default, precision_map) -> Dict[str, str]:
    if _world_size() > 1:
        raise NotImplementedError(_MULTI_PROCESS)
    if slice_size is not None and slice_size < 1:
        raise ValueError(f"slice_size must be a positive integer or None, got {slice_size!r}")
    devices = fleet_devices(device)
    device = devices[0]
    if fetch_retries is None:
        fetch_retries = int(os.environ.get(FETCH_RETRIES_ENV, "2"))
    if fetch_backoff is None:
        fetch_backoff = float(os.environ.get(FETCH_BACKOFF_ENV, "0.5"))
    # per-machine rungs beat the fleet default; a map entry naming no
    # machine of this fleet fails the build instead of building it f32
    fleet_precision = precision_mod.resolve_default(precision_default)
    precision_map = {name: precision_mod.validate(value)
                     for name, value in (precision_map or {}).items()}
    unknown = sorted(set(precision_map) - {machine.name for machine in machines})
    if unknown:
        raise ValueError(f"--precision-map names machines not in this fleet: {unknown}")

    def precision_of(name: str) -> str:
        return precision_map.get(name, fleet_precision)

    timer = PhaseTimer()
    started = time.perf_counter()
    results: Dict[str, str] = {}
    pending: List[Tuple[FleetMachineConfig, str, int, Optional[bool]]] = []
    ignored_eval: Dict[str, List[str]] = {}
    # the write-ahead log: started / committed / failed per machine; a
    # re-run replays it, so committed machines are skipped even without a
    # registry, and torn ones are provably redone
    journal = store_journal.BuildJournal(store_journal.journal_path(output_dir, 0))
    journal_states = store_journal.replay(output_dir)
    journal_counts = {"resumed": 0, "torn": 0, "rebuilt": 0}
    for machine in machines:
        eff_splits, eff_cv_parallel, ignored = _effective_splits(machine, n_splits)
        if ignored:
            ignored_eval[machine.name] = ignored
        # cv_parallel is not in the key: it is an execution strategy, and
        # flipping it resumes from existing artifacts
        cache_key = calculate_model_key(
            machine.name, machine.model_config, machine.data_config,
            evaluation_config={"n_splits": eff_splits, "cv_mode": "fleet"},
            precision=precision_of(machine.name))
        cached: Optional[str] = None
        if model_register_dir:
            cached = disk_registry.get_value(model_register_dir, cache_key)
        if cached is None:
            # the journal's committed record, for the SAME key only
            record = journal_states.get(machine.name)
            if (record is not None and record.get("event") == store_journal.EVENT_COMMITTED
                    and record.get("cache_key") == cache_key
                    and os.path.isdir(str(record.get("model_dir", "")))):
                cached = str(record["model_dir"])
        if cached is not None:
            # trust nothing unverified (structural check: a cached resume of
            # a large fleet stays O(stat); serving pays the hash pass)
            try:
                verify_artifact(resolve_artifact_dir(cached), deep=False)
            except StoreError as exc:
                logger.warning("Fleet resume: artifact for %r fails verification (%s); "
                               "rebuilding", machine.name, exc)
                journal_counts["torn"] += 1
            else:
                cached_precision = cached_artifact_precision(cached)
                if cached_precision != precision_of(machine.name):
                    logger.warning("Fleet resume: artifact for %r serves precision %s but this "
                                   "build pins %s; rebuilding", machine.name, cached_precision,
                                   precision_of(machine.name))
                else:
                    logger.info("Fleet cache hit for %r -> %s", machine.name, cached)
                    results[machine.name] = cached
                    journal_counts["resumed"] += 1
                    _M_FLEET_MACHINES.labels("cached").inc()
                    continue
        pending.append((machine, cache_key, eff_splits, eff_cv_parallel))
    if ignored_eval:
        logger.warning("Fleet builder ignores unsupported evaluation keys on %d machine(s) "
                       "(cv_mode is always 'fleet' here): %s%s", len(ignored_eval),
                       dict(list(ignored_eval.items())[:5]), " ..." if len(ignored_eval) > 5
                       else "")

    manifest: Dict[str, Dict[str, Any]] = {
        name: {"status": "cached", "model_dir": path} for name, path in results.items()}
    _write_manifest(output_dir, manifest, [m.name for m, *_ in pending],
                    journal_counts=journal_counts)

    # ---- bucket by (model config, widths, CV depth, fold mode) BEFORE
    # fetching: widths come from the dataset's declared columns, so host
    # memory holds one bucket's data, not the fleet's
    buckets: Dict[str, List[dict]] = {}
    for machine, cache_key, eff_splits, eff_cv_parallel in pending:
        dataset = _dataset_from_config(machine.data_config)
        item: dict = {"machine": machine, "cache_key": cache_key, "dataset": dataset}
        if hasattr(dataset, "_columns_for"):
            n_features = len(dataset._columns_for(dataset.tag_list))
            n_targets = len(dataset._columns_for(dataset.target_tag_list))
        else:  # widths need a fetch; a machine that fails it never buckets
            error = _fetch_machine_data(item, fetch_retries, fetch_backoff)
            if error is not None:
                logger.error("Isolating machine %r from fleet build (width probe): %s",
                             machine.name, error)
                manifest[machine.name] = {"status": "failed", "error": error}
                journal.record(machine.name, store_journal.EVENT_FAILED, error=error)
                _M_FLEET_MACHINES.labels("failed").inc()
                continue
            n_features, n_targets = item["X"].shape[1], item["y"].shape[1]
        item["F"], item["T"] = n_features, n_targets
        item["n_splits"] = eff_splits
        # resolved now, so an override that restates the default buckets
        # with its unannotated twins
        item["cv_parallel"] = (eff_cv_parallel if eff_cv_parallel is not None
                               else _derived_cv_parallel(machine.model_config))
        sig = json.dumps({"model_config": machine.model_config, "F": n_features, "T": n_targets,
                          "n_splits": item["n_splits"], "cv_parallel": item["cv_parallel"]},
                         sort_keys=True, default=str)
        buckets.setdefault(sig, []).append(item)

    if any(entry.get("status") == "failed" for entry in manifest.values()):
        _write_manifest(output_dir, manifest,
                        [m.name for m, *_ in pending if m.name not in manifest],
                        journal_counts=journal_counts)

    prefetcher = ThreadPoolExecutor(max_workers=1, thread_name_prefix="fleet-prefetch")
    try:
        for b, (sig, items) in enumerate(sorted(buckets.items())):
            bucket_started = time.perf_counter()
            model_config = items[0]["machine"].model_config
            analyzed = analyze_model(pipeline_from_definition(model_config))
            n_features, n_targets = items[0]["F"], items[0]["T"]
            bucket_splits = items[0]["n_splits"]
            spec = _spec_for(analyzed, n_features, n_targets, bucket_splits,
                             cv_parallel=items[0]["cv_parallel"])
            # each slice is a failure domain of its own; all are padded to
            # one machine count
            n_real = len(items)
            eff = n_real if not slice_size else min(slice_size, n_real)
            n_padded = pad_to_multiple(eff, len(devices))
            slices = [items[s:s + eff] for s in range(0, n_real, eff)]
            logger.info("Fleet bucket %d/%d: %d machines in %d slice(s) of %d (padded %d), F=%d",
                        b + 1, len(buckets), n_real, len(slices), eff, n_padded, n_features)
            quantize_rows = len(slices) > 1
            prepared = prefetcher.submit(_prepare_slice, slices[0], n_padded, n_features,
                                         n_targets, quantize_rows, fetch_retries, fetch_backoff)
            for s, slice_items in enumerate(slices):
                slice_started = time.perf_counter()
                X, y, w, n_rows, fetch_s = prepared.result()
                timer.add("data_fetch", fetch_s)
                if s + 1 < len(slices):
                    prepared = prefetcher.submit(_prepare_slice, slices[s + 1], n_padded,
                                                 n_features, n_targets, quantize_rows,
                                                 fetch_retries, fetch_backoff)
                batch = MachineBatch(X=X, y=y, w=w, keys=machine_seeds(seed, b, s, n_padded))
                with timer.phase("train"), device_trace(profile_dir):
                    result = _to_host(train_fleet_arrays(spec, batch, device=device))
                slice_duration = time.perf_counter() - slice_started
                with timer.phase("artifacts"):
                    # written before the next slice trains: a kill loses at
                    # most the slice in flight
                    for i, item in enumerate(slice_items):
                        machine = item["machine"]
                        if "build_error" in item:
                            # trained as zero-weight padding: no artifact, no
                            # registry key; the next run retries it
                            manifest[machine.name] = {"status": "failed",
                                                      "error": item["build_error"],
                                                      "bucket": b, "slice": s}
                            journal.record(machine.name, store_journal.EVENT_FAILED,
                                           error=item["build_error"])
                            _M_FLEET_MACHINES.labels("failed").inc()
                            continue
                        model = pipeline_from_definition(machine.model_config)
                        for est in estimators(model):
                            est.to(device)
                        _install_result(model, result, i, n_features, n_targets, bucket_splits)
                        model_dir = os.path.join(output_dir, machine.name)
                        amortized = slice_duration / max(len(slice_items), 1)
                        metadata = {
                            "name": machine.name,
                            "gordo_components_tpu_torch_version": __version__,
                            "model": {
                                "model_config": machine.model_config,
                                "model_builder_metadata": (
                                    model.get_metadata() if hasattr(model, "get_metadata")
                                    else {}),
                                "cross_validation": _cv_metadata(result, i, bucket_splits),
                                "model_training_duration_s": amortized,
                                "model_creation_date": time.strftime("%Y-%m-%d %H:%M:%S%z"),
                                "cache_key": item["cache_key"],
                                "fleet": {
                                    "bucket": b,
                                    "bucket_size": n_real,
                                    "slice": s,
                                    "slice_size": len(slice_items),
                                    "slice_duration_s": slice_duration,
                                    # the fold mode that trained it (not in the key)
                                    "cv_parallel": bool(spec.cv_parallel),
                                },
                            },
                            "dataset": item["dataset_metadata"],
                            "build_duration_s": amortized,
                            "build_phases": timer.report(),
                            "user_defined": dict(machine.metadata),
                            "precision": precision_of(machine.name),
                        }
                        # journal first, then the atomic generation, then the
                        # registry and the committed record: a crash anywhere
                        # leaves no trace (redo) or a whole artifact (skip)
                        journal.record(machine.name, store_journal.EVENT_STARTED,
                                       cache_key=item["cache_key"], bucket=b, slice=s)
                        commit_generation(
                            model_dir,
                            lambda staging: write_artifact_files(
                                model, staging, metadata=metadata,
                                precision=precision_of(machine.name)),
                            name=machine.name,
                        )
                        if model_register_dir:
                            disk_registry.write_key(model_register_dir, item["cache_key"],
                                                    model_dir)
                        journal.record(machine.name, store_journal.EVENT_COMMITTED,
                                       cache_key=item["cache_key"], model_dir=model_dir)
                        journal_counts["rebuilt"] += 1
                        results[machine.name] = model_dir
                        _M_FLEET_MACHINES.labels("completed").inc()
                        _M_MACHINE_BUILD_SECONDS.labels(machine.name).set(amortized)
                        manifest[machine.name] = {"status": "completed", "model_dir": model_dir,
                                                  "bucket": b, "slice": s}
                    _write_manifest(output_dir, manifest,
                                    [n for n in (m.name for m, *_ in pending) if n not in manifest],
                                    journal_counts=journal_counts)
                for item in slice_items:  # free before the next slice fetches
                    item.pop("X", None)
                    item.pop("y", None)
            logger.info("Fleet bucket %d/%d done in %.1fs", b + 1, len(buckets),
                        time.perf_counter() - bucket_started)
    finally:
        prefetcher.shutdown(wait=True, cancel_futures=True)
    timer.publish(prefix="gordo_fleet_build")
    logger.info("Fleet build: %d machines in %.1fs (%d cached); phases: %s", len(machines),
                time.perf_counter() - started, len(machines) - len(pending), timer.report())
    return results
