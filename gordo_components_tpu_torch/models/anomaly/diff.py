"""Diff-based anomaly detector (port of
``gordo_components_tpu/models/anomaly/diff.py:40-145, 193-243``).

The detector wraps a base pipeline. ``cross_validate`` runs the
reference's recipe: time-ordered folds (sklearn ``TimeSeriesSplit``'s
indices, kept here in :func:`time_series_split` since the port does not
import sklearn), a fresh clone of the base pipeline fitted per fold, the
four metrics per fold, then the per-tag error scaler fitted on the pooled
out-of-fold residuals ``|y - ŷ|`` and the thresholds at their 99th
percentile. ``fit`` trains the final model. The server scores through
:class:`gordo_components_tpu_torch.server.engine.ServingEngine`;
:meth:`DiffBasedAnomalyDetector.anomaly` is the reference's host path, its
DataFrame given as an :class:`AnomalyFrame` of arrays and column names.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..metrics import METRICS
from ..models import DenseAutoEncoder
from ..pipeline import clone_pipeline
from ..transformers import MinMaxScaler
from .base import AnomalyDetectorBase


def time_series_split(n_samples: int, n_splits: int = 3) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """sklearn's ``TimeSeriesSplit(n_splits).split`` indices (no gap, no
    maximum train size): ``n_splits`` test folds of ``n_samples //
    (n_splits + 1)`` rows at the end of the series, each trained on every
    row before it."""
    n_folds = n_splits + 1
    if n_folds > n_samples:
        raise ValueError(
            f"Cannot have number of folds={n_folds} greater than the number of "
            f"samples={n_samples}."
        )
    test_size = n_samples // n_folds
    indices = np.arange(n_samples)
    for test_start in range(n_samples - n_splits * test_size, n_samples, test_size):
        yield indices[:test_start], indices[test_start:test_start + test_size]


def _tail_align(y: np.ndarray, n_pred_rows: int) -> np.ndarray:
    if n_pred_rows > len(y):
        raise ValueError(f"Model produced {n_pred_rows} rows for {len(y)} target rows")
    return y[len(y) - n_pred_rows:]


def fold_scores(
    model: Any, X: np.ndarray, y: np.ndarray, n_splits: int, metrics: List[str]
) -> Tuple[List[Dict[str, Any]], List[np.ndarray]]:
    """Fit a fresh clone of ``model`` on each time-ordered fold; returns the
    fold records (sizes, scores, seconds) and each fold's absolute
    out-of-fold residuals."""
    splits, residuals = [], []
    for fold, (train_idx, test_idx) in enumerate(time_series_split(len(X), n_splits)):
        started = time.perf_counter()
        fold_model = clone_pipeline(model)
        fold_model.fit(X[train_idx], y[train_idx])
        pred = np.asarray(fold_model.predict(X[test_idx]))
        y_aligned = _tail_align(y[test_idx], len(pred))
        splits.append({
            "fold": fold,
            "n_train": int(len(train_idx)),
            "n_test": int(len(test_idx)),
            "scores": {name: METRICS[name](y_aligned, pred) for name in metrics},
            "duration_s": time.perf_counter() - started,
        })
        residuals.append(np.abs(y_aligned - pred))
    return splits, residuals


def cv_record(n_splits: int, splits: List[Dict[str, Any]], metrics: List[str]) -> Dict[str, Any]:
    """The reference's cross-validation record: the folds and the mean of
    each metric over them."""
    return {
        "n_splits": n_splits,
        "splits": splits,
        "scores": {
            name: float(np.mean([s["scores"][name] for s in splits])) for name in metrics
        },
    }


def fit_thresholds(scaler: Any, residuals: np.ndarray) -> Tuple[np.ndarray, float]:
    """Fit ``scaler`` on the pooled absolute residuals; return the per-tag
    thresholds (99th percentile of the scaled residuals) and the total
    threshold (99th percentile of their row norms)."""
    scaler.fit(residuals)
    scaled = np.asarray(scaler.transform(residuals))
    tag_thresholds = np.percentile(scaled, 99, axis=0).astype(np.float32)
    total_threshold = float(np.percentile(np.linalg.norm(scaled, axis=1), 99))
    return tag_thresholds, total_threshold


class AnomalyFrame(NamedTuple):
    """The reference's anomaly DataFrame without pandas: ``values`` (rows x
    columns, float32), ``columns`` (its two-level names: ``("model-input",
    tag)`` ..., ``("model-output", tag)`` ..., ``("tag-anomaly-scores",
    tag)`` ..., ``("total-anomaly-score", "")``) and ``index`` (the rows'
    timestamps, or ``None``)."""

    values: np.ndarray
    columns: List[Tuple[str, str]]
    index: Optional[np.ndarray]

    def __getitem__(self, key):
        """A top-level column block by name (``frame["model-output"]``),
        one column as a 1-D array (``frame["total-anomaly-score"]``, as
        pandas gives it); an integer still indexes the tuple."""
        if isinstance(key, str):
            cols = [i for i, (top, _) in enumerate(self.columns) if top == key]
            if not cols:
                raise KeyError(key)
            if [self.columns[i][1] for i in cols] == [""]:
                return self.values[:, cols[0]]
            return self.values[:, cols]
        return tuple.__getitem__(self, key)


class DiffBasedAnomalyDetector(AnomalyDetectorBase):
    def __init__(
        self,
        base_estimator: Any = None,
        scaler: Any = None,
        require_thresholds: bool = False,
    ):
        if base_estimator is None:
            base_estimator = DenseAutoEncoder()
        self.base_estimator = base_estimator
        self.scaler = scaler if scaler is not None else MinMaxScaler()
        self.require_thresholds = require_thresholds
        self.cross_validation_: Dict[str, Any] = {}
        self.tag_thresholds_: Optional[np.ndarray] = None
        self.total_threshold_: Optional[float] = None

    def _reject_joint_horizon(self) -> None:
        """A joint multi-step forecaster predicts the whole horizon per
        window; diff scoring compares one row per timestamp."""
        from ..analysis import analyze_model  # lazy: analysis imports this module

        try:
            est = analyze_model(self).estimator
        except ValueError:
            return
        if getattr(est, "joint_horizon", False):
            raise ValueError(
                "DiffBasedAnomalyDetector scores one row per timestamp; "
                f"{type(est).__name__} predicts the whole horizon jointly — use "
                "LSTMForecast(horizon=k) (direct k-step) for anomaly configs"
            )

    def fit(self, X, y=None, **kwargs) -> "DiffBasedAnomalyDetector":
        self._reject_joint_horizon()
        self.base_estimator.fit(X, y, **kwargs)
        return self

    def predict(self, X) -> np.ndarray:
        return self.base_estimator.predict(X)

    def score(self, X, y=None) -> float:
        return self.base_estimator.score(X, y)

    def anomaly(
        self,
        X,
        y=None,
        x_columns: Optional[Sequence[str]] = None,
        y_columns: Optional[Sequence[str]] = None,
        index: Optional[np.ndarray] = None,
    ) -> AnomalyFrame:
        """Score ``X`` against the targets ``y`` (``X`` by default): the
        inputs and predictions of the tail rows the model predicts, the
        per-tag errors scaled by the fitted error scaler (raw while the
        scaler is unfitted, unless ``require_thresholds``) and their row
        norm. Columns are named by ``x_columns`` / ``y_columns`` (else
        ``tag-i``), rows by the tail of ``index``."""
        if self.scaler.params_ is None and self.require_thresholds:
            raise ValueError("Anomaly scaler is not fitted; run cross_validate() first")
        X_vals = np.asarray(X, dtype=np.float32)
        y_vals = X_vals if y is None else np.asarray(y, dtype=np.float32)
        pred = np.asarray(self.predict(X_vals))
        y_aligned = _tail_align(y_vals, len(pred))
        error = np.abs(y_aligned - pred)
        scaled = error if self.scaler.params_ is None else np.asarray(self.scaler.transform(error))
        total = np.linalg.norm(scaled, axis=1)
        in_tags = list(x_columns) if x_columns else [f"tag-{i}" for i in range(X_vals.shape[1])]
        if y_columns:
            out_tags = list(y_columns)
        elif y is None and x_columns:
            out_tags = in_tags
        else:
            out_tags = [f"tag-{i}" for i in range(y_aligned.shape[1])]
        columns = ([("model-input", t) for t in in_tags] + [("model-output", t) for t in out_tags]
                   + [("tag-anomaly-scores", t) for t in out_tags]
                   + [("total-anomaly-score", "")])
        values = np.concatenate(
            [_tail_align(X_vals, len(pred)), pred, scaled, total[:, None]], axis=1)
        tail = None if index is None else np.asarray(index)[len(index) - len(pred):]
        return AnomalyFrame(values, columns, tail)

    def cross_validate(
        self, X, y=None, n_splits: int = 3, metrics: Optional[List[str]] = None
    ) -> Dict[str, Any]:
        """Time-ordered k-fold cross-validation: per-fold scores, then the
        error scaler and thresholds from the pooled out-of-fold residuals.
        Returns (and keeps as ``cross_validation_``) the reference's record."""
        self._reject_joint_horizon()
        X_arr = np.asarray(getattr(X, "values", X), dtype=np.float32)
        y_arr = X_arr if y is None else np.asarray(getattr(y, "values", y), dtype=np.float32)
        metrics = metrics or list(METRICS)
        splits, residuals = fold_scores(self.base_estimator, X_arr, y_arr, n_splits, metrics)
        self.tag_thresholds_, self.total_threshold_ = fit_thresholds(
            self.scaler, np.concatenate(residuals, axis=0)
        )
        self.cross_validation_ = cv_record(n_splits, splits, metrics)
        return self.cross_validation_

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        return {
            "base_estimator": self.base_estimator,
            "scaler": self.scaler,
            "require_thresholds": self.require_thresholds,
        }

    def get_metadata(self) -> Dict[str, Any]:
        meta: Dict[str, Any] = {
            "type": type(self).__name__,
            "base_estimator": (
                self.base_estimator.get_metadata()
                if hasattr(self.base_estimator, "get_metadata")
                else {}
            ),
        }
        if self.cross_validation_:
            meta["cross_validation"] = self.cross_validation_
        if self.tag_thresholds_ is not None:
            meta["tag_thresholds"] = [float(v) for v in self.tag_thresholds_]
            meta["total_threshold"] = self.total_threshold_
        return meta

    def get_state(self) -> Dict[str, Any]:
        state: Dict[str, Any] = {
            "base_estimator": (
                self.base_estimator.get_state()
                if hasattr(self.base_estimator, "get_state")
                else {}
            ),
            "scaler": (
                self.scaler.get_state() if hasattr(self.scaler, "get_state") else {}
            ),
            "cross_validation": self.cross_validation_,
        }
        if self.tag_thresholds_ is not None:
            state["tag_thresholds"] = np.asarray(self.tag_thresholds_)
            state["total_threshold"] = self.total_threshold_
        return state

    def set_state(self, state: Dict[str, Any]) -> "DiffBasedAnomalyDetector":
        if hasattr(self.base_estimator, "set_state"):
            self.base_estimator.set_state(state.get("base_estimator", {}))
        if hasattr(self.scaler, "set_state"):
            self.scaler.set_state(state.get("scaler", {}))
        self.cross_validation_ = state.get("cross_validation", {})
        if "tag_thresholds" in state:
            self.tag_thresholds_ = np.asarray(state["tag_thresholds"])
            self.total_threshold_ = state.get("total_threshold")
        return self
