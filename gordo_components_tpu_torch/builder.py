"""The model phase of a machine's build (port of
``gordo_components_tpu/builder/build_model.py:60-160``).

:func:`build_model` takes the machine's rows as numpy arrays (the dataset
layer is not ported) and runs the reference's sequence: the definition
becomes a pipeline, an anomaly detector cross-validates (time-ordered
folds, then its error scaler and thresholds) and any other pipeline gets
the plain fold scores, then the final fit; it returns the fitted model and
the reference's build metadata, which :func:`~.serializer.dump` writes
beside it. The estimators train on ``device`` (``cuda`` unless the caller
says ``"cpu"``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from . import __version__
from .models.anomaly.diff import DiffBasedAnomalyDetector, cv_record, fold_scores
from .models.metrics import METRICS
from .serializer import pipeline_from_definition, pipeline_into_definition
from .serializer.persistence import estimators
from .utils.backend import DeviceLike, resolve_device

_CV_MODES = ("full_build", "cross_val_only", "build_only")


def build_model(
    name: str,
    model_config: Dict[str, Any],
    X: np.ndarray,
    y: Optional[np.ndarray] = None,
    metadata: Optional[Dict[str, Any]] = None,
    evaluation_config: Optional[Dict[str, Any]] = None,
    dataset_metadata: Optional[Dict[str, Any]] = None,
    device: DeviceLike = None,
) -> Tuple[Any, Dict[str, Any]]:
    """Build one machine's model from its rows; returns ``(fitted model,
    build metadata)``. ``evaluation_config``: ``{"cv_mode": "full_build" |
    "cross_val_only" | "build_only", "n_splits": int}``, as in the
    reference (``cross_val_only`` skips the final fit, ``build_only`` the
    cross-validation)."""
    evaluation_config = dict(evaluation_config or {})
    cv_mode = evaluation_config.get("cv_mode", "full_build")
    if cv_mode not in _CV_MODES:
        raise ValueError(f"Unknown cv_mode {cv_mode!r}")
    n_splits = int(evaluation_config.get("n_splits", 3))
    device = resolve_device(device)
    build_started = time.perf_counter()
    X = np.asarray(getattr(X, "values", X), dtype=np.float32)
    y = X if y is None else np.asarray(getattr(y, "values", y), dtype=np.float32)

    model = pipeline_from_definition(model_config)
    for est in estimators(model):
        est.to(device)
    phases: Dict[str, Dict[str, Any]] = {}

    cv_metadata: Dict[str, Any] = {}
    if cv_mode != "build_only":
        started = time.perf_counter()
        if isinstance(model, DiffBasedAnomalyDetector):
            cv_metadata = model.cross_validate(X, y, n_splits=n_splits)
        else:  # fold scores alone: only a detector fits thresholds
            splits, _ = fold_scores(model, X, y, n_splits, list(METRICS))
            cv_metadata = cv_record(n_splits, splits, list(METRICS))
        cv_metadata["cv_duration_s"] = time.perf_counter() - started
        phases["cross_validation"] = {"total_s": cv_metadata["cv_duration_s"], "count": 1}

    fit_duration = None
    if cv_mode != "cross_val_only":
        started = time.perf_counter()
        model.fit(X, y)
        fit_duration = time.perf_counter() - started
        phases["fit"] = {"total_s": fit_duration, "count": 1}

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
        "build_duration_s": time.perf_counter() - build_started,
        "build_phases": dict(sorted(phases.items())),
        "user_defined": dict(metadata or {}),
    }
    return model, build_metadata
