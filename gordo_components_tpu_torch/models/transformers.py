"""Affine pipeline scalers (port of ``gordo_components_tpu/models/transformers.py:24-121``).

State is the reference's: ``{"scale", "offset"}`` arrays of a fitted
:class:`~gordo_components_tpu_torch.ops.scaling.ScalerParams`, held here as
float32 numpy (the host side of a pipeline); the engine moves them to the
card. ``fit`` works too — it is a column min/max or mean/std — so a port
user can prepare a machine's scalers without the reference package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import scaling


def _numpy_params(params: scaling.ScalerParams) -> scaling.ScalerParams:
    return scaling.ScalerParams(
        scale=np.asarray(params.scale, np.float32),
        offset=np.asarray(params.offset, np.float32),
    )


class _BaseScaler:
    def __init__(self):
        self.params_: Optional[scaling.ScalerParams] = None

    def _fit_params(self, X: torch.Tensor) -> scaling.ScalerParams:
        raise NotImplementedError

    def fit(self, X, y=None, **_kwargs):
        X = torch.as_tensor(np.asarray(getattr(X, "values", X), np.float32))
        self.params_ = _numpy_params(self._fit_params(X))
        return self

    def _checked(self, X) -> np.ndarray:
        if self.params_ is None:
            raise ValueError(f"{type(self).__name__} is not fitted")
        X = np.asarray(getattr(X, "values", X), dtype=np.float32)
        expected = len(np.atleast_1d(self.params_.scale))
        if X.ndim >= 1 and X.shape[-1] != expected:
            raise ValueError(
                f"{type(self).__name__} was fitted with {expected} features "
                f"but got {X.shape[-1]}"
            )
        return X

    def transform(self, X) -> np.ndarray:
        return scaling.transform(self.params_, self._checked(X))

    def inverse_transform(self, X) -> np.ndarray:
        return scaling.inverse_transform(self.params_, self._checked(X))

    def get_state(self) -> Dict[str, Any]:
        if self.params_ is None:
            return {}
        return {"scale": self.params_.scale, "offset": self.params_.offset}

    def set_state(self, state: Dict[str, Any]):
        if state:
            self.params_ = _numpy_params(
                scaling.ScalerParams(state["scale"], state["offset"])
            )
        return self


class MinMaxScaler(_BaseScaler):
    """Per-feature min-max to ``feature_range`` (sklearn semantics)."""

    def __init__(self, feature_range: Tuple[float, float] = (0.0, 1.0)):
        super().__init__()
        self.feature_range = tuple(feature_range)

    def _fit_params(self, X):
        return scaling.fit_minmax(X, feature_range=self.feature_range)

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        return {"feature_range": list(self.feature_range)}


class StandardScaler(_BaseScaler):
    """Per-feature standardization (sklearn semantics)."""

    def __init__(self, with_mean: bool = True, with_std: bool = True):
        super().__init__()
        self.with_mean = with_mean
        self.with_std = with_std

    def _fit_params(self, X):
        params = scaling.fit_standard(X)
        scale = params.scale if self.with_std else torch.ones_like(params.scale)
        mean = (
            -params.offset / params.scale
            if self.with_mean
            else torch.zeros_like(params.offset)
        )
        return scaling.ScalerParams(scale=scale, offset=-mean * scale)

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        return {"with_mean": self.with_mean, "with_std": self.with_std}
