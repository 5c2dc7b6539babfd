"""Diff-based anomaly detector state (port of
``gordo_components_tpu/models/anomaly/diff.py:40-56, 193-243``).

The detector wraps a base pipeline and holds the per-tag error scaler and
thresholds fitted by the reference's ``cross_validate``. Scoring goes
through :class:`gordo_components_tpu_torch.server.engine.ServingEngine`;
the reference's pandas host path (``anomaly`` → DataFrame) is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..models import DenseAutoEncoder
from ..transformers import MinMaxScaler


class DiffBasedAnomalyDetector:
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

    def fit(self, X, y=None, **kwargs):
        raise NotImplementedError(
            "training is not ported yet (ROADMAP.md, Queue 1: training)"
        )

    def predict(self, X) -> np.ndarray:
        return self.base_estimator.predict(X)

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        return {
            "base_estimator": self.base_estimator,
            "scaler": self.scaler,
            "require_thresholds": self.require_thresholds,
        }

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
