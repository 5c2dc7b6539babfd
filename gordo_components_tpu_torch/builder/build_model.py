"""The build entry point: config → data → model → CV → fit → artifact (the
port's copy of ``gordo_components_tpu/builder/build_model.py:1-309``).

:func:`build_model` assembles the dataset from its config (the numpy
dataset layer, ``dataset/``), turns the definition into a pipeline,
cross-validates (a detector: time-ordered folds, then its error scaler and
thresholds; any other pipeline: the plain fold scores), fits, and returns
the fitted model with the reference's build metadata. The estimators train
on ``device`` (``cuda`` unless the caller says ``"cpu"``).
:func:`provide_saved_model` adds the idempotent build: an md5 of the
configs keys a disk registry, and the artifact lands as a new committed
generation (``gen-NNNN`` + ``CURRENT``) under the output dir.
"""

from __future__ import annotations

import hashlib
import json
import logging
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .. import __version__
from .. import precision as precision_mod
from ..dataset import GordoBaseDataset
from ..models.anomaly.diff import DiffBasedAnomalyDetector, cv_record, fold_scores
from ..models.metrics import METRICS
from ..observability.registry import REGISTRY
from ..ops import _kernels
from ..serializer import load_metadata, pipeline_from_definition, pipeline_into_definition
from ..serializer.persistence import estimators, write_artifact_files
from ..store.errors import StoreError
from ..store.generations import commit_generation, resolve_artifact_dir
from ..store.manifest import verify_artifact
from ..utils import disk_registry
from ..utils.backend import DeviceLike, resolve_device
from ..utils.profiling import PhaseTimer

logger = logging.getLogger(__name__)

_CV_MODES = ("full_build", "cross_val_only", "build_only")

_M_BUILD_SECONDS = REGISTRY.gauge(
    "gordo_build_duration_seconds",
    "Wall-clock duration of each machine's most recent single-machine build",
    labels=("machine",),
)
_M_BUILDS = REGISTRY.counter(
    "gordo_builds_total",
    "Single-machine builds completed, by outcome (built / cached)",
    labels=("outcome",),
)


def _dataset_from_config(data_config: Dict[str, Any]) -> GordoBaseDataset:
    config = dict(data_config)
    config.setdefault("type", "TimeSeriesDataset")
    return GordoBaseDataset.from_dict(config)


def _evaluation(evaluation_config: Optional[Dict[str, Any]]) -> Tuple[str, int]:
    evaluation_config = dict(evaluation_config or {})
    cv_mode = evaluation_config.get("cv_mode", "full_build")
    if cv_mode not in _CV_MODES:
        raise ValueError(f"Unknown cv_mode {cv_mode!r}")
    return cv_mode, int(evaluation_config.get("n_splits", 3))


def build_model(
    name: str,
    model_config: Dict[str, Any],
    data_config: Dict[str, Any],
    metadata: Optional[Dict[str, Any]] = None,
    evaluation_config: Optional[Dict[str, Any]] = None,
    device: DeviceLike = None,
) -> Tuple[Any, Dict[str, Any]]:
    """Build one machine's model from its data config; returns ``(fitted
    model, build metadata)``. ``evaluation_config``: ``{"cv_mode":
    "full_build" | "cross_val_only" | "build_only", "n_splits": int}``
    (``cross_val_only`` skips the final fit, ``build_only`` the
    cross-validation). Phases timed: ``data_fetch``, ``cross_validation``,
    ``fit``."""
    _evaluation(evaluation_config)
    device = resolve_device(device)
    started = time.perf_counter()
    timer = PhaseTimer()
    with timer.phase("data_fetch"):
        dataset = _dataset_from_config(data_config)
        X, y = dataset.get_data()
    return _build_from_rows(name, model_config, X, y, metadata, evaluation_config,
                            dataset.get_metadata(), device, timer, started)


def _build_from_rows(
    name: str,
    model_config: Dict[str, Any],
    X: np.ndarray,
    y: Optional[np.ndarray] = None,
    metadata: Optional[Dict[str, Any]] = None,
    evaluation_config: Optional[Dict[str, Any]] = None,
    dataset_metadata: Optional[Dict[str, Any]] = None,
    device: DeviceLike = None,
    timer: Optional[PhaseTimer] = None,
    started: Optional[float] = None,
) -> Tuple[Any, Dict[str, Any]]:
    """The model phase of :func:`build_model` over rows already fetched
    (``y`` defaults to ``X``); ``timer`` and ``started`` carry the data
    phase's accounting in."""
    cv_mode, n_splits = _evaluation(evaluation_config)
    device = resolve_device(device)
    started = time.perf_counter() if started is None else started
    timer = PhaseTimer() if timer is None else timer
    X = np.asarray(X, dtype=np.float32)
    y = X if y is None else np.asarray(y, dtype=np.float32)

    model = pipeline_from_definition(model_config)
    for est in estimators(model):
        est.to(device)

    cv_metadata: Dict[str, Any] = {}
    if cv_mode != "build_only":
        cv_started = time.perf_counter()
        with timer.phase("cross_validation"):
            if isinstance(model, DiffBasedAnomalyDetector):
                cv_metadata = model.cross_validate(X, y, n_splits=n_splits)
            else:  # fold scores alone: only a detector fits thresholds
                splits, _ = fold_scores(model, X, y, n_splits, list(METRICS))
                cv_metadata = cv_record(n_splits, splits, list(METRICS))
        cv_metadata["cv_duration_s"] = time.perf_counter() - cv_started

    fit_duration = None
    if cv_mode != "cross_val_only":
        fit_started = time.perf_counter()
        with timer.phase("fit"):
            model.fit(X, y)
        fit_duration = time.perf_counter() - fit_started

    # phase accounting goes into the artifact's metadata and the registry
    timer.publish()
    _M_BUILD_SECONDS.labels(name).set(time.perf_counter() - started)
    _M_BUILDS.labels("built").inc()

    build_metadata: Dict[str, Any] = {
        "name": name,
        "gordo_components_tpu_torch_version": __version__,
        "model": {
            "model_config": pipeline_into_definition(model),
            "model_builder_metadata": (
                model.get_metadata() if hasattr(model, "get_metadata") else {}
            ),
            "cross_validation": cv_metadata,
            "model_training_duration_s": fit_duration,
            "model_creation_date": time.strftime("%Y-%m-%d %H:%M:%S%z"),
        },
        "dataset": dict(dataset_metadata or {}),
        "build_duration_s": time.perf_counter() - started,
        "build_phases": timer.report(),
        "user_defined": dict(metadata or {}),
    }
    return model, build_metadata


def cached_artifact_precision(model_dir: str) -> str:
    """The precision a cached artifact's CURRENT generation pins, checked
    against the requested rung on every cache hit: the registry value is
    the machine's shared output dir, whose CURRENT a later build at another
    rung may have swapped. An unreadable pin matches nothing, so the hit
    becomes a rebuild."""
    try:
        return precision_mod.of_metadata(load_metadata(model_dir))
    except ValueError:
        return "<unreadable>"


def calculate_model_key(
    name: str,
    model_config: Dict[str, Any],
    data_config: Dict[str, Any],
    gordo_version: Optional[str] = None,
    evaluation_config: Optional[Dict[str, Any]] = None,
    precision: str = "f32",
) -> str:
    """md5 over the sorted-key JSON of (name, model config, data config,
    evaluation config, framework version), plus the precision unless it is
    f32 (so every f32 key of the reference's format stays valid)."""
    payload = {
        "name": name,
        "model_config": model_config,
        "data_config": data_config,
        "evaluation_config": evaluation_config or {},
        "gordo_version": gordo_version or __version__,
    }
    if precision != "f32":
        payload["precision"] = precision
    return hashlib.md5(json.dumps(payload, sort_keys=True, default=str).encode()).hexdigest()


def provide_saved_model(
    name: str,
    model_config: Dict[str, Any],
    data_config: Dict[str, Any],
    output_dir: str,
    metadata: Optional[Dict[str, Any]] = None,
    model_register_dir: Optional[str] = None,
    replace_cache: bool = False,
    evaluation_config: Optional[Dict[str, Any]] = None,
    precision: Optional[str] = None,
    device: DeviceLike = None,
    compile_cache_store: Any = None,
) -> str:
    """Idempotent build; returns the model dir (a generation root).

    A registered key whose artifact passes the structural check
    (``verify_artifact(deep=False)``) and pins the requested precision is
    a cache hit; a torn artifact or another rung rebuilds. Otherwise the
    model is built (:func:`build_model`) and committed as a new
    ``gen-NNNN`` under ``output_dir`` with ``CURRENT`` swapped to it, and
    the key registered. ``precision`` (default ``GORDO_PRECISION_DEFAULT``,
    else f32) is pinned into the build metadata; int8 also writes the
    quantized sidecar. Training always runs in the model's own dtype.
    ``compile_cache_store``: a :class:`~..compile_cache.CompileCacheStore`
    the fit's kernel libraries (forward and backward) resolve through."""
    precision = precision_mod.resolve_default(precision)
    if (evaluation_config or {}).get("cv_mode") == "cross_val_only":
        raise ValueError(
            "cv_mode='cross_val_only' skips the final fit and produces no servable artifact; "
            "use build_model() directly for evaluation runs")
    cache_key = calculate_model_key(name, model_config, data_config,
                                    evaluation_config=evaluation_config, precision=precision)
    if model_register_dir and not replace_cache:
        cached = disk_registry.get_value(model_register_dir, cache_key)
        if cached:
            try:
                verify_artifact(resolve_artifact_dir(cached), deep=False)
                cached_precision = cached_artifact_precision(cached)
            except StoreError as exc:
                logger.warning("Cached artifact for %r fails verification (%s); rebuilding",
                               name, exc)
            else:
                if cached_precision != precision:
                    logger.warning("Cached artifact for %r serves precision %s but this build "
                                   "pins %s; rebuilding", name, cached_precision, precision)
                else:
                    logger.info("Model %r cache hit (key %s) -> %s", name, cache_key, cached)
                    _M_BUILDS.labels("cached").inc()
                    return cached
    if model_register_dir and replace_cache:
        disk_registry.delete_key(model_register_dir, cache_key)

    with _kernels.use_store(compile_cache_store):
        model, build_metadata = build_model(name, model_config, data_config, metadata,
                                            evaluation_config, device=device)
    build_metadata["model"]["cache_key"] = cache_key
    build_metadata["precision"] = precision
    commit_generation(
        output_dir,
        lambda staging: write_artifact_files(model, staging, metadata=build_metadata,
                                             precision=precision),
        name=name,
    )
    if model_register_dir:
        disk_registry.write_key(model_register_dir, cache_key, output_dir)
    return output_dir
