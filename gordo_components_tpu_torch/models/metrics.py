"""Evaluation metrics as plain numpy functions (port of
``gordo_components_tpu/models/metrics.py:16-49``): sklearn's semantics
with ``multioutput="uniform_average"``, without sklearn."""

from __future__ import annotations

import numpy as np


def _uniform_average(num: np.ndarray, den: np.ndarray) -> float:
    with np.errstate(divide="ignore", invalid="ignore"):
        scores = 1.0 - num / den
    # sklearn: a zero-variance output scores 1.0 if predicted exactly, else 0.0
    scores = np.where(den == 0.0, np.where(num == 0.0, 1.0, 0.0), scores)
    return float(np.mean(scores))


def explained_variance_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    return _uniform_average(np.var(y_true - y_pred, axis=0), np.var(y_true, axis=0))


def r2_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    num = np.sum((y_true - y_pred) ** 2, axis=0)
    den = np.sum((y_true - np.mean(y_true, axis=0)) ** 2, axis=0)
    return _uniform_average(num, den)


def mean_squared_error(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    diff = np.asarray(y_true, np.float64) - np.asarray(y_pred, np.float64)
    return float(np.mean(diff * diff))


def mean_absolute_error(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    diff = np.asarray(y_true, np.float64) - np.asarray(y_pred, np.float64)
    return float(np.mean(np.abs(diff)))


METRICS = {
    "explained_variance_score": explained_variance_score,
    "r2_score": r2_score,
    "mean_squared_error": mean_squared_error,
    "mean_absolute_error": mean_absolute_error,
}
