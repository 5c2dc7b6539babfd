"""Estimator wrappers (port of ``gordo_components_tpu/models/models.py``:
``BaseFlaxEstimator`` 59-102 and 255-269, state 335-353, the zoo's
estimators 356-466 and the Keras aliases 471-473).

The port serves fitted artifacts: an estimator is built from its
definition kwargs, then :meth:`BaseTorchEstimator.set_state` loads the
reference's flax parameter tree into a torch module. ``fit`` raises —
training is a later slice. The windowing contract is the reference's:
``lookahead`` None = flat rows, 0 = reconstruction, k ≥ 1 = forecast.

An estimator has no device until :meth:`BaseTorchEstimator.to` is called;
until then ``set_state`` and ``predict`` resolve ``None``, which is
``cuda`` and raises without a card (see ``utils/backend.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops import windowing
from ..utils.backend import DeviceLike, resolve_device
from .convert import params_from_flax
from .register import get_factory


def _as_float32(X) -> np.ndarray:
    arr = np.asarray(getattr(X, "values", X), dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[:, None]
    return arr


class BaseTorchEstimator:
    """Common state and predict machinery; subclasses set ``lookahead``."""

    lookahead: Optional[int] = None  # class-level contract

    def __init__(self, kind: str, **kwargs: Any):
        self.kind = kind
        self.batch_size = int(kwargs.pop("batch_size", 32))
        self.epochs = int(kwargs.pop("epochs", 1))
        self.seed = int(kwargs.pop("seed", 0))
        self.factory_kwargs = kwargs
        # fitted state
        self.params_: Optional[Dict[str, Any]] = None  # the flax tree, as stored
        self.module_: Optional[torch.nn.Module] = None
        self.history_: list = []
        self.n_features_: Optional[int] = None
        self.n_features_out_: Optional[int] = None
        self.fit_duration_: Optional[float] = None
        self.device: Optional[torch.device] = None  # cuda unless to("cpu")

    @property
    def lookback_window(self) -> int:
        if self.lookahead is None:
            return 1
        return int(self.factory_kwargs.get("lookback_window", 1))

    def _make_spec(self, n_features: int, n_features_out: int):
        spec = get_factory(self.kind)(
            n_features=n_features, n_features_out=n_features_out,
            **self.factory_kwargs,
        )
        expected = "flat" if self.lookahead is None else "window"
        if spec.input_kind != expected:
            raise ValueError(
                f"Model kind {self.kind!r} produces {spec.input_kind!r} inputs "
                f"but {type(self).__name__} requires {expected!r}"
            )
        return spec

    def fit(self, X, y=None, **_kwargs):
        raise NotImplementedError(
            "training is not ported yet (ROADMAP.md, Queue 1: training); "
            "fit with gordo_components_tpu and load the artifact"
        )

    def _check_fitted(self) -> None:
        if self.module_ is None:
            raise ValueError(f"{type(self).__name__} is not fitted")

    def to(self, device: DeviceLike) -> "BaseTorchEstimator":
        self.device = resolve_device(device)
        if self.module_ is not None:
            self.module_.to(self.device)
        return self

    def predict(self, X) -> np.ndarray:
        """Predictions aligned per the windowing contract."""
        self._check_fitted()
        x = torch.as_tensor(_as_float32(X), device=resolve_device(self.device))
        if self.lookahead is not None:
            x = windowing.sliding_windows(x, self.lookback_window, self.lookahead)
        with torch.inference_mode():
            return self.module_(x).cpu().numpy()

    # -- introspection / persistence ----------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "batch_size": self.batch_size,
            "epochs": self.epochs,
            "seed": self.seed,
            **self.factory_kwargs,
        }

    def get_state(self) -> Dict[str, Any]:
        self._check_fitted()
        return {
            "params": self.params_,
            "n_features": self.n_features_,
            "n_features_out": self.n_features_out_,
            "history": self.history_,
            "fit_duration": self.fit_duration_,
        }

    def set_state(self, state: Dict[str, Any]) -> "BaseTorchEstimator":
        self.n_features_ = int(state["n_features"])
        self.n_features_out_ = int(state["n_features_out"])
        self.history_ = list(state.get("history", []))
        self.fit_duration_ = state.get("fit_duration")
        spec = self._make_spec(self.n_features_, self.n_features_out_)
        self.params_ = state["params"]
        module = params_from_flax(spec.module, self.params_)
        self.module_ = module.eval().to(resolve_device(self.device))
        return self


class DenseAutoEncoder(BaseTorchEstimator):
    """X→X reconstruction with a feedforward kind, one output row per input
    row (reference: ``KerasAutoEncoder``)."""

    lookahead = None

    def __init__(self, kind: str = "feedforward_hourglass", **kwargs: Any):
        super().__init__(kind, **kwargs)


class LSTMAutoEncoder(BaseTorchEstimator):
    """Window → window's own last row (reference: ``KerasLSTMAutoEncoder``).
    ``predict`` row ``j`` corresponds to input row ``j + lookback_window -
    1``; the PatchTST estimators inherit this contract."""

    lookahead = 0

    def __init__(self, kind: str = "lstm_hourglass", **kwargs: Any):
        super().__init__(kind, **kwargs)


class LSTMForecast(BaseTorchEstimator):
    """Window → the ``horizon``-th-ahead row (reference: ``KerasLSTMForecast``
    is the ``horizon=1`` case). ``predict`` row ``j`` corresponds to input
    row ``j + lookback_window - 1 + horizon``."""

    lookahead = 1

    def __init__(self, kind: str = "lstm_symmetric", horizon: int = 1, **kwargs: Any):
        super().__init__(kind, **kwargs)
        if int(horizon) < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        self.horizon = int(horizon)
        self.lookahead = self.horizon

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        return {**super().get_params(deep), "horizon": self.horizon}


class MultiStepForecast(LSTMForecast):
    """Joint multi-step forecast: window → all of rows ``t+1..t+horizon``
    together. The head emits ``horizon × n_features_out`` values per window;
    ``predict`` returns the flat ``(count, horizon·F)`` shape and
    :meth:`predict_steps` the ``(count, horizon, F)`` view. The anomaly
    engine scores one row per timestamp and refuses this estimator."""

    joint_horizon = True

    def __init__(self, kind: str = "lstm_symmetric", horizon: int = 2, **kwargs: Any):
        super().__init__(kind, horizon=horizon, **kwargs)

    def _make_spec(self, n_features: int, n_features_out: int):
        return super()._make_spec(n_features, n_features_out * self.horizon)

    def predict_steps(self, X) -> np.ndarray:
        """Step ``s`` of row ``j`` forecasts input row ``j + lookback_window + s``."""
        flat = self.predict(X)
        return flat.reshape(flat.shape[0], self.horizon, -1)


class PatchTSTAutoEncoder(LSTMAutoEncoder):
    """Window → window's own last row via the PatchTST kind."""

    def __init__(self, kind: str = "patchtst", **kwargs: Any):
        kwargs.setdefault("lookback_window", 32)
        super().__init__(kind, **kwargs)


class PatchTSTForecast(LSTMForecast):
    """Window → next row via the PatchTST kind."""

    def __init__(self, kind: str = "patchtst", **kwargs: Any):
        kwargs.setdefault("lookback_window", 32)
        super().__init__(kind, **kwargs)


# the reference's Keras class names (the definition table maps their
# ``gordo_components.model.models`` paths here)
KerasAutoEncoder = DenseAutoEncoder
KerasLSTMAutoEncoder = LSTMAutoEncoder
KerasLSTMForecast = LSTMForecast
