"""Fleet builder: N machine configs → one stacked program per bucket →
per-machine artifacts identical to the single-machine builder's (the
port's copy of ``gordo_components_tpu/parallel/build_fleet.py``).

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

**Ranks.** Inside a ``torch.distributed`` group of W ranks
(:mod:`.distributed`) every rank runs the same bucketing and slicing; a
slice pads to a multiple of W machines and rank r fetches, trains,
checkpoints and commits only its contiguous block ``[lo, hi)``
(:func:`_local_machine_span`) on its own device; padding machines are
not trained. A machine's training reads nothing of the others in its
stack, so each comes out as in a one-rank build, provided that every rank
trains over the same row axis (the slice's longest machine: an
all-gather agrees on it) and each machine draws the seed of its place in
the padded slice (``machine_seeds`` is prefix-stable in the machine
count). The reference's ``_gather_local_block`` has no
counterpart: a rank's result is already its own block, on its own device.
What crosses ranks is host-side control: that row count, a digest of the
build plan, whether a slice checkpoint exists, and the barrier before one
is deleted, all over ``gloo``. Each rank writes its own manifest
(``fleet_manifest.p<rank>.json`` past rank 0) and journal
(``build_journal.jsonl.p<rank>``); a re-run replays every journal, so all
ranks start from the same ``pending`` list.

**Resume** keeps the slices: cached machines are bucketed and sliced
with the rest, a slice whose machines are all resolved is skipped, and in
one with a machine still to build only those train, the resolved ones
counting towards the row axis from their metadata, unfetched. So a
re-run trains every machine with the key and row axis of a build that
never stopped, and gives the same artifacts (the reference re-slices the
pending machines, which moves their keys), at the cost of the pending
machines alone. A rank that dies, or a slice
that wedges past ``GORDO_SLICE_TIMEOUT_S`` (:class:`_SliceWatchdog`), ends
the survivors with :data:`EXIT_RETRYABLE`.

**Slice checkpoints** (:class:`_SliceCheckpointer`): each trained slice's
stacked result is written beside the output (one ``.npz`` per rank, from a
background thread) before its artifacts, and deleted once they are all
durable, so a kill between training and the last commit restores the
slice instead of retraining it. The format is the port's own: a re-run of
the port does not read an orbax checkpoint the reference left behind.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import tempfile
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import __version__
from .. import precision as precision_mod
from ..analysis import lockcheck
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
from ..serializer import load_metadata, pipeline_from_definition
from ..serializer.persistence import estimators, write_artifact_files
from ..store import journal as store_journal
from ..store.errors import StoreError
from ..store.atomic import fsync_dir, fsync_file
from ..store.generations import commit_generation, resolve_artifact_dir
from ..store.manifest import verify_artifact
from ..utils import disk_registry
from ..utils.backend import DeviceLike
from ..utils.profiling import PhaseTimer, device_trace
from . import distributed
from .fleet import FLEET_CV_METRICS, FleetSpec, MachineBatch, MachineResult, train_fleet_arrays
from .mesh import pad_to_multiple

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
# few backed-off retries; a machine that still fails is left out of its
# slice's training and recorded failed instead of killing the others
FETCH_RETRIES_ENV = "GORDO_BUILD_FETCH_RETRIES"
FETCH_BACKOFF_ENV = "GORDO_BUILD_FETCH_BACKOFF"

# exit code of a tripped slice watchdog and of a failed collective:
# EX_TEMPFAIL, deliberately not the permanent config/data codes (64/66)
EXIT_RETRYABLE = 75

# the per-slice watchdog of a build of several ranks (seconds; unset: none)
SLICE_TIMEOUT_ENV = "GORDO_SLICE_TIMEOUT_S"
_CKPT_SUBDIR = ".slice_checkpoints"
# a checkpoint's entry naming the machines it holds, by place in the block
_CKPT_POSITIONS = "positions"


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
    span: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, List[int], float]:
    """Host-side ingest of one slice's span ``[lo, hi)`` of its padded
    machines (default: all ``n_padded``): the provider fetches, then the
    stacked arrays ``(len(positions), n_rows, ·)`` of the machines to build
    and their ``positions`` within the span. It runs on the prefetch worker,
    so slice s+1's fetch overlaps slice s's training. Rows are
    RIGHT-aligned (they end at the bucket's latest timestamp); padding rows
    have weight 0. Padding machines are not trained, nor are resolved ones
    (``item["cached"]``), whose row counts come from their metadata
    (``item["rows"]``; fetched when it has none) so that the row axis is
    the whole span's. A machine whose fetch fails after its retries carries
    ``build_error`` and is not trained. The row count is the span's own: a
    build of several ranks agrees on the slice's before it trains (never
    from this worker, so that every rank orders its collectives alike).
    Every shape is an argument, not a closure over the caller's loop."""
    started = time.perf_counter()
    lo, hi = span if span is not None else (0, n_padded)
    local_items = slice_items[lo:min(hi, len(slice_items))]

    def fetch_one(item: dict) -> None:
        error = _fetch_machine_data(item, fetch_retries, fetch_backoff)
        if error is not None and item.get("cached") is not None:
            item["rows"] = 0  # resolved already: only its row count is missing
        elif error is not None:
            logger.error("Isolating machine %r from fleet build: %s",
                         item["machine"].name, error)
            item["build_error"] = error
            item["X"] = np.zeros((0, n_features), np.float32)
            item["y"] = np.zeros((0, n_targets), np.float32)
            item["dataset_metadata"] = {}

    # the width probe's are in, and a resolved machine needs only its rows
    to_fetch = [item for item in local_items if "X" not in item
                and (item.get("cached") is None or item.get("rows") is None)]
    if len(to_fetch) > 1:
        # independent, I/O-bound fetches: overlap their latency
        with ThreadPoolExecutor(max_workers=min(8, len(to_fetch)),
                                thread_name_prefix="fleet-fetch") as pool:
            list(pool.map(fetch_one, to_fetch))
    else:
        for item in to_fetch:
            fetch_one(item)

    def rows_of(item: dict) -> int:
        return len(item["X"]) if "X" in item else int(item["rows"])

    positions = [i for i, item in enumerate(local_items)
                 if item.get("cached") is None and "build_error" not in item]
    # an all-failed slice still needs a nonzero row axis
    n_rows = max(max((rows_of(item) for item in local_items), default=1), 1)
    if quantize_rows:
        n_rows = -(-n_rows // _ROW_QUANTUM) * _ROW_QUANTUM
    X = np.zeros((len(positions), n_rows, n_features), np.float32)
    y = np.zeros((len(positions), n_rows, n_targets), np.float32)
    w = np.zeros((len(positions), n_rows), np.float32)
    for m, i in enumerate(positions):
        item = local_items[i]
        rows = len(item["X"])
        X[m, n_rows - rows:] = item["X"]
        y[m, n_rows - rows:] = item["y"]
        w[m, n_rows - rows:] = 1.0
    return X, y, w, n_rows, positions, time.perf_counter() - started


def _local_machine_span(n_padded: int, world: int, rank: int) -> Tuple[int, int]:
    """The contiguous ``[lo, hi)`` of a padded slice's machines that rank
    ``rank`` of ``world`` builds (the reference derives it from its mesh's
    sharding; ranks here are the shards). ``n_padded`` is a multiple of
    ``world``."""
    if n_padded % world:
        raise ValueError(f"{n_padded} machines do not divide over {world} ranks")
    block = n_padded // world
    return rank * block, (rank + 1) * block


def _pad_rows(X: np.ndarray, y: np.ndarray, w: np.ndarray,
              n_rows: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Leading zero-weight rows up to ``n_rows``: every machine stays
    right-aligned on the slice's agreed row axis."""
    pad = n_rows - X.shape[1]
    if pad <= 0:
        return X, y, w
    rows = ((0, 0), (pad, 0))
    return np.pad(X, rows + ((0, 0),)), np.pad(y, rows + ((0, 0),)), np.pad(w, rows)


def _write_manifest(
    output_dir: str,
    completed: Dict[str, Dict[str, Any]],
    pending: List[str],
    journal_counts: Optional[Dict[str, int]] = None,
    rank: int = 0,
) -> None:
    """The fleet's completion record, rewritten atomically after every
    slice: ``<output_dir>/fleet_manifest.json``, or for rank r > 0 of a
    build of several ranks ``fleet_manifest.p<r>.json`` (its own machines,
    so concurrent writers never clobber each other; a monitor unions the
    files). ``journal_counts`` is the resume accounting (``resumed``,
    ``torn``, ``rebuilt``)."""
    manifest_file = MANIFEST_FILE
    if rank:
        stem, ext = os.path.splitext(MANIFEST_FILE)
        manifest_file = f"{stem}.p{rank}{ext}"
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
        os.replace(tmp, os.path.join(output_dir, manifest_file))
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


def _result_arrays(result: MachineResult) -> Dict[str, np.ndarray]:
    """A host stacked result as flat named arrays (``params.<leaf>``,
    ``input_scaler.scale``, ``loss_history``, …): the checkpoint's entries."""
    arrays: Dict[str, np.ndarray] = {}
    for field_name, value in result._asdict().items():
        if isinstance(value, dict):
            arrays.update({f"{field_name}.{k}": np.asarray(v) for k, v in value.items()})
        elif isinstance(value, ScalerParams):
            arrays[f"{field_name}.scale"] = np.asarray(value.scale)
            arrays[f"{field_name}.offset"] = np.asarray(value.offset)
        else:
            arrays[field_name] = np.asarray(value)
    return arrays


def _result_from_arrays(arrays: Dict[str, np.ndarray]) -> MachineResult:
    """The inverse of :func:`_result_arrays`; a missing entry raises."""
    params = {key.split(".", 1)[1]: value for key, value in arrays.items()
              if key.startswith("params.")}
    if not params:
        raise ValueError("no parameters in the checkpoint")

    def scaler(name: str) -> ScalerParams:
        return ScalerParams(scale=arrays[f"{name}.scale"], offset=arrays[f"{name}.offset"])

    return MachineResult(
        params=params,
        input_scaler=scaler("input_scaler"),
        target_scaler=scaler("target_scaler"),
        error_scaler=scaler("error_scaler"),
        loss_history=arrays["loss_history"],
        cv_scores=arrays["cv_scores"],
        tag_thresholds=arrays["tag_thresholds"],
        total_threshold=arrays["total_threshold"],
    )


class _SliceCheckpointer:
    """A checkpoint of each trained slice's stacked result, kept until the
    slice's artifacts are all durable (the reference's orbax checkpointer,
    ``_SliceCheckpointer``, without orbax): a build killed between
    training and its last commit restores the slice on the re-run instead
    of retraining it. Steady state leaves nothing behind.

    Layout: ``<output>/.slice_checkpoints/slice_<key>/rank<r>-of<W>.npz``,
    one file per rank holding the machines of its block that it trained
    and their places in the block (``positions``), keyed by the md5 of the
    slice's cache keys. A file is written from a background thread (it overlaps
    the artifact loop) to a temporary name and ``os.replace``d, so a crash
    never leaves a final path; it holds no pickle. Zero-size leaves
    (``cv_scores`` with CV off) round-trip as they are.

    With several ranks, whether a checkpoint exists is agreed by an
    all-gather (every rank takes the same branch), an unreadable one
    raises instead of diverging, and a slice's checkpoint is deleted by
    rank 0 after a barrier, once every rank's artifacts are durable. A
    checkpoint of another world size is not read (its file names differ):
    the slice retrains."""

    def __init__(self, output_dir: str, world: int = 1, rank: int = 0):
        self._root = os.path.abspath(os.path.join(output_dir, _CKPT_SUBDIR))
        self._world, self._rank = world, rank
        # the writer thread and its deferred error; a leaf lock
        self._lock = lockcheck.named_lock("fleet.checkpoint")
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    @staticmethod
    def slice_key(slice_items: List[dict]) -> str:
        """The slice's content key: the md5 of its machines' cache keys
        (which hash the name and the model, data and evaluation configs),
        never positional (bucket, slice) indices: a changed fleet slices
        otherwise, and a stale checkpoint must not restore another slice's
        machines."""
        return hashlib.md5(json.dumps([item["cache_key"] for item in slice_items])
                           .encode()).hexdigest()

    def path(self, key: str) -> str:
        return os.path.join(self._root, f"slice_{key}")

    def _file(self, key: str) -> str:
        return os.path.join(self.path(key), f"rank{self._rank}-of{self._world}.npz")

    def try_restore(self, key: str, positions: List[int]) -> Optional[MachineResult]:
        """This rank's machines ``positions`` (within its block, in that
        order) from the slice's checkpoint, or None to train them. A rank
        with none agrees to whatever the others find and restores nothing.
        A checkpoint that lacks one of them (a machine isolated when it was
        written) is not used: the rank trains them all, which its peers'
        restores do not mind (training holds no collective)."""
        path = self._file(key)
        exists = os.path.isfile(path) if positions else True
        if self._world > 1:
            exists = bool(distributed.allgather_ints([int(exists)]).all())
        if not exists or not positions:
            return None
        try:
            with np.load(path, allow_pickle=False) as npz:
                arrays = {name: npz[name] for name in npz.files}
            held = arrays.pop(_CKPT_POSITIONS).tolist()
            result = _result_from_arrays(arrays)
        except Exception as exc:
            if self._world > 1:
                # this rank retraining while the others restored would
                # break the ranks' agreement: fail the build (retryably),
                # and drop the file so that the re-run votes to retrain
                os.unlink(path)
                raise distributed.RankFailure(
                    f"slice checkpoint {path} unreadable ({type(exc).__name__}: {exc}); "
                    "removed, re-run every rank") from exc
            logger.warning("Slice checkpoint %s unreadable (%s: %s); retraining", path,
                           type(exc).__name__, exc)
            return None
        if not set(positions) <= set(held):
            logger.info("Slice checkpoint %s holds machines %s of this rank's block, not %s; "
                        "retraining", key, held, positions)
            return None
        rows = [held.index(i) for i in positions]
        logger.info("Restored slice checkpoint %s (skipping retrain)", key)
        return _result_from_arrays({name: value[rows]
                                    for name, value in _result_arrays(result).items()})

    def save_async(self, key: str, result: MachineResult, positions: List[int]) -> None:
        """Write this rank's trained machines, ``positions`` within its
        block (the stack's rows, in order), from a background thread (one
        at a time: a save still in flight is waited for first)."""
        self._wait()
        arrays = {**_result_arrays(result), _CKPT_POSITIONS: np.asarray(positions, np.int64)}
        final = self._file(key)

        def write() -> None:
            tmp = f"{final}.{uuid.uuid4().hex[:8]}.tmp"
            try:
                os.makedirs(os.path.dirname(final), exist_ok=True)
                with open(tmp, "wb") as fh:
                    np.savez(fh, **arrays)
                fsync_file(tmp)
                os.replace(tmp, final)
                fsync_dir(os.path.dirname(final))
            except BaseException as exc:  # noqa: BLE001 - deferred to the waiter
                if os.path.exists(tmp):
                    os.unlink(tmp)
                with self._lock:
                    self._error = exc

        thread = threading.Thread(target=write, name="fleet-checkpoint", daemon=True)
        with self._lock:
            self._thread = thread
        thread.start()

    def _wait(self) -> Optional[BaseException]:
        """Join the save in flight; its error, if it failed."""
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        with self._lock:
            error, self._error = self._error, None
        return error

    def join(self) -> None:
        """Wait for a save in flight without deleting anything (the
        exception path: the build's own error must propagate, so a failed
        save is logged, never raised)."""
        error = self._wait()
        if error is not None:
            logger.warning("Slice-checkpoint save failed during build abort: %s: %s",
                           type(error).__name__, error)

    def finalize(self, key: str) -> None:
        """The slice's artifacts are durable: wait for its save, then (all
        ranks past a barrier) rank 0 deletes the checkpoint. A failed save
        is only logged: there is nothing left to restore."""
        error = self._wait()
        if error is not None:
            logger.warning("Slice checkpoint %s was not written (%s: %s); its artifacts are "
                           "durable", key, type(error).__name__, error)
        distributed.barrier()
        if self._rank == 0:
            shutil.rmtree(self.path(key), ignore_errors=True)

    def close(self) -> None:
        """The build finished: rank 0 removes the checkpoint root."""
        self.join()
        if self._rank == 0:
            shutil.rmtree(self._root, ignore_errors=True)


class _SliceWatchdog:
    """Failure detection for a build of several ranks (the reference's
    ``_SliceWatchdog``). A dead peer can leave a survivor blocked inside a
    collective that no exception will end, so with ``GORDO_SLICE_TIMEOUT_S``
    set each slice iteration must finish inside the budget, or the process
    logs CRITICAL and exits :data:`EXIT_RETRYABLE` through ``os._exit``: a
    thread blocked in a ``gloo`` collective cannot be interrupted from
    Python. Restarting every rank then resumes from the registry, the
    journals and the slice checkpoints. Size the budget above the worst
    healthy slice wall: it is a liveness bound. A one-rank build never
    arms it (no peer can stall it, and killing it would lose the slice in
    flight for nothing)."""

    def __init__(self, multi_rank: bool, timeout_s: Optional[float] = None, rank: int = 0):
        if timeout_s is None:
            raw = os.environ.get(SLICE_TIMEOUT_ENV, "")
            timeout_s = float(raw) if raw else 0.0
        self.multi_rank = bool(multi_rank)
        self.armed = bool(multi_rank and timeout_s > 0)
        self.timeout_s = timeout_s
        self.rank = rank
        self._timer: Optional[threading.Timer] = None
        self._where = ""
        self._started: Optional[float] = None

    def start(self, where: str) -> None:
        """Arm a fresh budget for one slice iteration (a no-op unarmed; a
        build of several ranks times the span all the same)."""
        self.stop()
        self._where = where
        self._started = time.perf_counter()
        if not self.armed:
            return
        self._timer = threading.Timer(self.timeout_s, self._trip)
        self._timer.daemon = True
        self._timer.start()

    def stop(self) -> None:
        """End the span; a build of several ranks logs what it took at
        DEBUG, the healthy walls a budget is sized from (armed or not)."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if self._started is not None and self.multi_rank:
            logger.debug("Fleet slice span: %s took %.3fs on rank %d", self._where,
                        time.perf_counter() - self._started, self.rank)
        self._started = None

    def _trip(self) -> None:
        try:
            logger.critical(
                "Fleet slice watchdog: %s exceeded %.0fs on rank %d — a peer process has likely "
                "died mid-collective; exiting %d (retryable) so the job layer restarts all "
                "processes and the re-run resumes from registry + slice checkpoints",
                self._where, self.timeout_s, self.rank, EXIT_RETRYABLE)
            logging.shutdown()  # the line must reach the stream before os._exit
        finally:
            os._exit(EXIT_RETRYABLE)


def _cached_shape(cached: Optional[str]) -> Optional[Tuple[int, int, int]]:
    """A resolved machine's row count and its feature and target widths,
    from its committed metadata (no fetch), or None."""
    if cached is None:
        return None
    try:
        dataset = load_metadata(cached)["dataset"]
        return (int(dataset["x_shape"][0]), int(dataset["x_shape"][1]),
                int(dataset["y_shape"][1]))
    except (OSError, KeyError, IndexError, TypeError, ValueError):
        return None


def _plan_digest(buckets: Dict[str, List[dict]]) -> int:
    """A 63-bit digest of the build plan (buckets, machines, widths, and
    which machines are resolved: a rank skips the collectives of a slice
    it sees resolved): the ranks must agree on it before any slice
    trains."""
    plan = sorted((sig, [(item["machine"].name, item["cached"] is not None) for item in items])
                  for sig, items in buckets.items())
    return int(hashlib.md5(json.dumps(plan).encode()).hexdigest()[:15], 16)


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
    0.5 s) is left out of the training, gets no artifact and is recorded
    ``failed`` in the manifest and the journal; the next run retries it.

    **Resume**: a machine whose key is registered — or, without a
    registry, whose journal record says ``committed`` under the same key —
    is skipped once its artifact passes structural verification and pins
    the requested rung; a torn one is rebuilt and counted ``torn`` in the
    manifest's ``journal`` block (beside ``resumed`` and ``rebuilt``).

    **Slices**: a bucket larger than ``slice_size`` trains in slices of
    that many machines, each padded to the same count (a machine's seed is
    its place there), of which only the machines still to build train; a
    slice's
    artifacts, registry keys and journal records land as it finishes, so a
    kill loses at most the slice in flight. ``slice_size=None`` trains a
    bucket in one stack. ``profile_dir`` wraps the training in
    ``torch.profiler``. A trained slice is checkpointed until its
    artifacts land (:class:`_SliceCheckpointer`).

    **Ranks**: inside a ``torch.distributed`` group of several ranks
    (:func:`.distributed.initialize_multihost`) this rank builds only its
    block of every slice (the module docstring) on ``device``; the
    returned mapping covers the cached machines and its own. Output and
    registry directories must be shared by the ranks."""
    with _kernels.use_store(compile_cache_store):
        return _build_fleet(machines, output_dir, model_register_dir, device, seed, n_splits,
                            profile_dir, slice_size, fetch_retries, fetch_backoff,
                            precision_default, precision_map)


def _build_fleet(machines, output_dir, model_register_dir, device, seed, n_splits,
                 profile_dir, slice_size, fetch_retries, fetch_backoff,
                 precision_default, precision_map) -> Dict[str, str]:
    if slice_size is not None and slice_size < 1:
        raise ValueError(f"slice_size must be a positive integer or None, got {slice_size!r}")
    device, world, rank = distributed.global_fleet_devices(device)
    multi_rank = world > 1
    if multi_rank:
        logger.info("Fleet build of %d ranks: rank %d fetches, trains and commits only its own "
                    "block of every slice on %s", world, rank, device)
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
    # every machine: (config, cache key, CV depth, fold mode, its cached
    # artifact or None); the pending ones are those without
    entries: List[Tuple[FleetMachineConfig, str, int, Optional[bool], Optional[str]]] = []
    ignored_eval: Dict[str, List[str]] = {}
    # the write-ahead log: started / committed / failed per machine; a
    # re-run replays it, so committed machines are skipped even without a
    # registry, and torn ones are provably redone
    journal = store_journal.BuildJournal(store_journal.journal_path(output_dir, rank))
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
                    entries.append((machine, cache_key, eff_splits, eff_cv_parallel, cached))
                    continue
        entries.append((machine, cache_key, eff_splits, eff_cv_parallel, None))
    pending = [entry[:4] for entry in entries if entry[4] is None]
    if ignored_eval:
        logger.warning("Fleet builder ignores unsupported evaluation keys on %d machine(s) "
                       "(cv_mode is always 'fleet' here): %s%s", len(ignored_eval),
                       dict(list(ignored_eval.items())[:5]), " ..." if len(ignored_eval) > 5
                       else "")

    manifest: Dict[str, Dict[str, Any]] = {
        name: {"status": "cached", "model_dir": path} for name, path in results.items()}
    _write_manifest(output_dir, manifest, [m.name for m, *_ in pending],
                    journal_counts=journal_counts, rank=rank)

    # ---- bucket by (model config, widths, CV depth, fold mode) BEFORE
    # fetching: widths come from the dataset's declared columns, so host
    # memory holds one bucket's data, not the fleet's. Cached machines are
    # bucketed and sliced too, so that a slice is the same machines in
    # every run (the reference re-slices the pending ones): a resumed
    # machine then trains with the key, and over the row axis, of a build
    # that never stopped. A slice whose machines are all cached is skipped
    buckets: Dict[str, List[dict]] = {}
    for machine, cache_key, eff_splits, eff_cv_parallel, cached in (entries if pending else []):
        dataset = _dataset_from_config(machine.data_config)
        item: dict = {"machine": machine, "cache_key": cache_key, "dataset": dataset,
                      "cached": cached}
        shape = _cached_shape(cached)
        if shape is not None:
            item["rows"] = shape[0]  # its slice's row axis counts it unfetched
        if hasattr(dataset, "_columns_for"):
            n_features = len(dataset._columns_for(dataset.tag_list))
            n_targets = len(dataset._columns_for(dataset.target_tag_list))
        elif shape is not None:
            n_features, n_targets = shape[1:]
        elif multi_rank:
            # widths need a fetch, and every rank must bucket alike: a
            # failure aborts this rank (its peers then exit retryably)
            # rather than isolating the machine on one rank only
            X_probe, y_probe = dataset.get_data()
            item["X"] = np.asarray(X_probe, np.float32)
            item["y"] = np.asarray(y_probe, np.float32)
            item["dataset_metadata"] = dataset.get_metadata()
            n_features, n_targets = item["X"].shape[1], item["y"].shape[1]
        else:  # widths need a fetch; a machine that fails it never buckets
            error = _fetch_machine_data(item, fetch_retries, fetch_backoff)
            if error is not None and cached is not None:
                continue  # resolved already; its slice builds without it
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
                        journal_counts=journal_counts, rank=rank)
    watchdog = _SliceWatchdog(multi_rank, rank=rank)
    if multi_rank:
        # every rank must run the same buckets and slices in the same order,
        # or their collectives pair up wrongly
        watchdog.start("the build plan's agreement")
        digests = distributed.allgather_ints([_plan_digest(buckets)])
        watchdog.stop()
        if len(set(digests[:, 0].tolist())) != 1:
            raise distributed.RankFailure(
                "the ranks disagree on the build plan (registry, journal or data changed "
                "between their scans); re-run every rank")

    checkpointer = _SliceCheckpointer(output_dir, world, rank)
    prefetcher = ThreadPoolExecutor(max_workers=1, thread_name_prefix="fleet-prefetch")
    try:
        for b, (sig, items) in enumerate(sorted(buckets.items())):
            bucket_started = time.perf_counter()
            # each slice is a failure domain of its own; all are padded to
            # one machine count, which spaces the machines' seeds
            n_real = len(items)
            eff = n_real if not slice_size else min(slice_size, n_real)
            n_padded = pad_to_multiple(eff, world)
            slices = [items[s:s + eff] for s in range(0, n_real, eff)]
            # a slice with a machine to build: only those train, each with
            # its own key over the whole slice's row axis
            todo = [s for s, slice_items in enumerate(slices)
                    if any(item["cached"] is None for item in slice_items)]
            if not todo:
                continue
            model_config = items[0]["machine"].model_config
            analyzed = analyze_model(pipeline_from_definition(model_config))
            n_features, n_targets = items[0]["F"], items[0]["T"]
            bucket_splits = items[0]["n_splits"]
            spec = _spec_for(analyzed, n_features, n_targets, bucket_splits,
                             cv_parallel=items[0]["cv_parallel"])
            logger.info("Fleet bucket %d/%d: %d machines in %d slice(s) of %d (padded %d, %d to "
                        "build), F=%d", b + 1, len(buckets), n_real, len(slices), eff, n_padded,
                        len(todo), n_features)
            quantize_rows = len(slices) > 1
            lo, hi = span = _local_machine_span(n_padded, world, rank)
            prepared = prefetcher.submit(_prepare_slice, slices[todo[0]], n_padded, n_features,
                                         n_targets, quantize_rows, fetch_retries, fetch_backoff,
                                         span)
            for t, s in enumerate(todo):
                slice_items = slices[s]
                # armed with several ranks and GORDO_SLICE_TIMEOUT_S only
                watchdog.start(f"bucket {b} slice {s}")
                slice_started = time.perf_counter()
                X, y, w, n_rows, positions, fetch_s = prepared.result()
                timer.add("data_fetch", fetch_s)
                if t + 1 < len(todo):
                    prepared = prefetcher.submit(_prepare_slice, slices[todo[t + 1]], n_padded,
                                                 n_features, n_targets, quantize_rows,
                                                 fetch_retries, fetch_backoff, span)
                if multi_rank:
                    # the slice's longest machine sets every rank's row axis,
                    # as it does a one-rank build's
                    n_rows = int(distributed.allgather_ints([n_rows]).max())
                    X, y, w = _pad_rows(X, y, w, n_rows)
                # this rank's machines, indexed within its block; those to
                # build (``positions``) are the rows of the stack it trains
                indexed_items = [(i - lo, item) for i, item in enumerate(slice_items)
                                 if lo <= i < hi]
                row_of = {i: m for m, i in enumerate(positions)}
                ckpt_key = checkpointer.slice_key(slice_items)
                result = checkpointer.try_restore(ckpt_key, positions)
                if result is None and positions:
                    # a machine's key is that of its place in the padded slice
                    keys = machine_seeds(seed, b, s, n_padded)[[lo + i for i in positions]]
                    with timer.phase("train"), device_trace(profile_dir):
                        result = _to_host(train_fleet_arrays(
                            spec, MachineBatch(X=X, y=y, w=w, keys=keys), device=device))
                    # written while the artifacts below are; finalize() joins
                    checkpointer.save_async(ckpt_key, result, positions)
                slice_duration = time.perf_counter() - slice_started
                with timer.phase("artifacts"):
                    # written before the next slice trains: a kill loses at
                    # most the slice in flight
                    for i, item in indexed_items:
                        machine = item["machine"]
                        if item["cached"] is not None:
                            continue  # resolved by an earlier run
                        if "build_error" in item:
                            # not trained: no artifact, no registry key; the
                            # next run retries it
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
                        _install_result(model, result, row_of[i], n_features, n_targets,
                                        bucket_splits)
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
                                "cross_validation": _cv_metadata(result, row_of[i],
                                                                 bucket_splits),
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
                                    journal_counts=journal_counts, rank=rank)
                with timer.phase("checkpoint_wait"):
                    # artifacts durable: join the save, drop the checkpoint
                    checkpointer.finalize(ckpt_key)
                for item in slice_items:  # free before the next slice fetches
                    item.pop("X", None)
                    item.pop("y", None)
                watchdog.stop()  # the slice made progress; start() re-arms
            logger.info("Fleet bucket %d/%d done in %.1fs", b + 1, len(buckets),
                        time.perf_counter() - bucket_started)
    finally:
        watchdog.stop()
        prefetcher.shutdown(wait=True, cancel_futures=True)
        checkpointer.join()
    checkpointer.close()
    timer.publish(prefix="gordo_fleet_build")
    logger.info("Fleet build: %d machines in %.1fs (%d cached); phases: %s", len(machines),
                time.perf_counter() - started, len(machines) - len(pending), timer.report())
    return results
