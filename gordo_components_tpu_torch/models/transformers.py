"""Pipeline-step transformers (port of
``gordo_components_tpu/models/transformers.py:24-245``).

The affine scalers' state is the reference's: ``{"scale", "offset"}``
arrays of a fitted :class:`~gordo_components_tpu_torch.ops.scaling.ScalerParams`,
held here as float32 numpy (the host side of a pipeline); the engine moves
them to the card. ``InfImputer`` keeps ``{"pos_fill", "neg_fill"}``;
``FunctionTransformer`` has no state and names its function by one of the
paths in :data:`FUNCTIONS`, never by an arbitrary import path.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..ops import scaling
from .base import GordoBase


def _numpy_params(params: scaling.ScalerParams) -> scaling.ScalerParams:
    return scaling.ScalerParams(
        scale=np.asarray(params.scale, np.float32),
        offset=np.asarray(params.offset, np.float32),
    )


class _BaseScaler(GordoBase):
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

    def fit_transform(self, X, y=None) -> np.ndarray:
        return self.fit(X).transform(X)

    def get_metadata(self) -> Dict[str, Any]:
        return {"type": type(self).__name__, **self.get_params()}

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


class InfImputer(GordoBase):
    """Replace ±inf with the per-feature finite extremes seen at fit time,
    or with the explicit fill values given."""

    def __init__(
        self,
        inf_fill_value: Optional[float] = None,
        neg_inf_fill_value: Optional[float] = None,
    ):
        self.inf_fill_value = inf_fill_value
        self.neg_inf_fill_value = neg_inf_fill_value
        self.pos_fill_: Optional[np.ndarray] = None
        self.neg_fill_: Optional[np.ndarray] = None

    def fit(self, X, y=None, **_kwargs) -> "InfImputer":
        X = np.asarray(getattr(X, "values", X), dtype=np.float32)
        finite = np.where(np.isfinite(X), X, np.nan)
        with np.errstate(all="ignore"):
            self.pos_fill_ = np.nan_to_num(np.nanmax(finite, axis=0), nan=0.0)
            self.neg_fill_ = np.nan_to_num(np.nanmin(finite, axis=0), nan=0.0)
        if self.inf_fill_value is not None:
            self.pos_fill_ = np.full(X.shape[1], self.inf_fill_value, np.float32)
        if self.neg_inf_fill_value is not None:
            self.neg_fill_ = np.full(X.shape[1], self.neg_inf_fill_value, np.float32)
        return self

    def transform(self, X) -> np.ndarray:
        if self.pos_fill_ is None:
            raise ValueError("InfImputer is not fitted")
        X = np.array(getattr(X, "values", X), dtype=np.float32)
        pos, neg = np.isposinf(X), np.isneginf(X)
        X[pos] = np.broadcast_to(self.pos_fill_, X.shape)[pos]
        X[neg] = np.broadcast_to(self.neg_fill_, X.shape)[neg]
        return X

    def fit_transform(self, X, y=None) -> np.ndarray:
        return self.fit(X).transform(X)

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        return {
            "inf_fill_value": self.inf_fill_value,
            "neg_inf_fill_value": self.neg_inf_fill_value,
        }

    def get_metadata(self) -> Dict[str, Any]:
        return {"type": type(self).__name__, **self.get_params()}

    def get_state(self) -> Dict[str, Any]:
        if self.pos_fill_ is None:
            return {}
        return {"pos_fill": self.pos_fill_, "neg_fill": self.neg_fill_}

    def set_state(self, state: Dict[str, Any]) -> "InfImputer":
        if state:
            self.pos_fill_ = np.asarray(state["pos_fill"])
            self.neg_fill_ = np.asarray(state["neg_fill"])
        return self


def multiply(X, factor: float = 1.0) -> np.ndarray:
    """The reference's ``transformer_funcs.general.multiply``."""
    return np.asarray(getattr(X, "values", X)) * factor


# the functions a FunctionTransformer may name, under every path the
# reference's definitions use for them
FUNCTIONS: Dict[str, Callable] = {
    "gordo_components_tpu.models.transformers.multiply": multiply,
    "gordo_components.model.transformer_funcs.general.multiply": multiply,
    "multiply": multiply,
}


class FunctionTransformer(GordoBase):
    """A stateless function as a pipeline step (sklearn's
    ``FunctionTransformer`` surface, minus validation knobs)."""

    def __init__(
        self,
        func: Union[str, Callable, None] = None,
        inverse_func: Union[str, Callable, None] = None,
        kw_args: Optional[Dict[str, Any]] = None,
        inv_kw_args: Optional[Dict[str, Any]] = None,
    ):
        self.func = func
        self.inverse_func = inverse_func
        self.kw_args = kw_args
        self.inv_kw_args = inv_kw_args

    @staticmethod
    def _resolve(func) -> Callable:
        if func is None:
            return lambda X: X
        if isinstance(func, str):
            try:
                return FUNCTIONS[func]
            except KeyError:
                raise ValueError(
                    f"FunctionTransformer: {func!r} is not a function the port knows; "
                    f"known: {sorted(FUNCTIONS)}"
                ) from None
        return func

    def fit(self, X, y=None, **_kwargs) -> "FunctionTransformer":
        return self

    def transform(self, X) -> np.ndarray:
        return self._resolve(self.func)(X, **(self.kw_args or {}))

    def fit_transform(self, X, y=None) -> np.ndarray:
        return self.transform(X)

    def inverse_transform(self, X) -> np.ndarray:
        return self._resolve(self.inverse_func)(X, **(self.inv_kw_args or {}))

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        return {
            "func": self.func if isinstance(self.func, str) else None,
            "inverse_func": self.inverse_func if isinstance(self.inverse_func, str) else None,
            "kw_args": self.kw_args,
            "inv_kw_args": self.inv_kw_args,
        }

    def get_metadata(self) -> Dict[str, Any]:
        return {"type": type(self).__name__, **self.get_params()}
