"""Decompose a loaded config graph into estimator, scalers and detector
(port of ``gordo_components_tpu/models/analysis.py:34-60``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from .anomaly.diff import DiffBasedAnomalyDetector
from .models import BaseTorchEstimator
from .pipeline import Pipeline, TransformedTargetRegressor
from .transformers import MinMaxScaler, StandardScaler


@dataclass
class Analyzed:
    estimator: BaseTorchEstimator
    input_scaler: Optional[Any]
    target_scaler: Optional[Any]
    detector: Optional[DiffBasedAnomalyDetector]


def analyze_model(model: Any) -> Analyzed:
    """``DiffBasedAnomalyDetector(TransformedTargetRegressor(Pipeline([scaler,
    estimator])))`` and its sub-shapes; raises ``ValueError`` otherwise."""
    detector = model if isinstance(model, DiffBasedAnomalyDetector) else None
    core = detector.base_estimator if detector else model
    target_scaler = None
    if isinstance(core, TransformedTargetRegressor):
        target_scaler = core.transformer
        core = core.regressor
    input_scaler = None
    if isinstance(core, Pipeline):
        steps = [step for _, step in core.steps]
        if len(steps) == 2 and isinstance(steps[0], (MinMaxScaler, StandardScaler)):
            input_scaler, core = steps[0], steps[1]
        elif len(steps) == 1:
            core = steps[0]
        else:
            raise ValueError(
                "The engine supports Pipeline([scaler, estimator]) or "
                f"Pipeline([estimator]); got {len(steps)} steps"
            )
    if not isinstance(core, BaseTorchEstimator):
        raise ValueError(
            f"The engine requires a zoo estimator at the core; got "
            f"{type(core).__name__}"
        )
    return Analyzed(core, input_scaler, target_scaler, detector)
