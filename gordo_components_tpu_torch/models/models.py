"""Estimator wrappers (port of ``gordo_components_tpu/models/models.py``:
``BaseFlaxEstimator`` 59-278, state 335-353, the zoo's estimators 356-466
and the Keras aliases 471-473).

An estimator is built from its definition kwargs. It either loads a fitted
flax parameter tree (:meth:`BaseTorchEstimator.set_state`, the reference's
artifacts) or trains one (:meth:`BaseTorchEstimator.fit`). The windowing
contract is the reference's: ``lookahead`` None = flat rows, 0 =
reconstruction, k ≥ 1 = forecast.

``fit`` follows the reference step by step: the factory's module, its
optimizer and loss; parameters drawn from flax's initial distributions;
one shuffled pass over the (padded) rows per epoch; windowed models train
on window START indices and gather each batch's windows from the ``(n, F)``
rows, never building the L×-larger window tensor. The draws differ: the
port cannot draw ``jax.random``, so one ``torch.Generator(seed)`` on the
CPU draws the initial parameters, every permutation and every step's
dropout key, the same on the card and the CPU, and the masks hashed from
a key are the same on both. A port-trained model at seed s is
not the reference's model at seed s; it is one of the same distribution.

An estimator has no device until :meth:`BaseTorchEstimator.to` is called;
until then ``fit``, ``set_state`` and ``predict`` resolve ``None``, which
is ``cuda`` and raises without a card (see ``utils/backend.py``).
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..ops import windowing
from ..utils.backend import DeviceLike, nan_guard, resolve_device
from .base import GordoBase
from .convert import flax_from_params, params_from_flax
from .factories.transformer import PatchTSTModule
from .metrics import explained_variance_score
from .modules import OptimizedLSTMCell
from .register import get_factory
from .train import make_fit_fn, pad_to_batches


def _as_float32(X) -> np.ndarray:
    arr = np.asarray(getattr(X, "values", X), dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[:, None]
    return arr


# flax's lecun_normal: a normal truncated to ±2 standard deviations, scaled
# so that its standard deviation is sqrt(1 / fan_in); this constant is the
# standard deviation of the standard normal truncated to (-2, 2)
_TRUNCATED_STD = 0.87962566103423978


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
    weight.mul_(math.sqrt(1.0 / fan_in) / _TRUNCATED_STD)


@torch.no_grad()
def init_flax_distributions(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw ``module``'s parameters (on the CPU) from the distributions flax
    initialises the reference's modules with: Dense and DenseGeneral
    kernels lecun-normal over their fan-in and biases zero; LayerNorm scale
    one and bias zero; PatchTST's ``pos_embedding`` normal(0.02); an LSTM
    cell's input kernels lecun-normal, its recurrent kernels orthogonal per
    gate, its recurrent biases zero. The values are drawn from
    ``generator`` in the order of ``module.modules()``."""
    for sub in module.modules():
        if isinstance(sub, nn.Linear):
            _lecun_normal_(sub.weight, sub.in_features, generator)
            sub.bias.zero_()
        elif isinstance(sub, nn.LayerNorm):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
        elif isinstance(sub, OptimizedLSTMCell):
            _lecun_normal_(sub.input_kernel, sub.input_kernel.shape[0], generator)
            for gate in sub.recurrent_kernel.split(sub.units, dim=1):
                gate.copy_(nn.init.orthogonal_(torch.empty_like(gate), generator=generator))
            sub.recurrent_bias.zero_()
        elif isinstance(sub, PatchTSTModule):
            sub.pos_embedding.normal_(0.0, 0.02, generator=generator)
    return module


class BaseTorchEstimator(GordoBase):
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
        self.architecture_: Optional[Dict[str, Any]] = None  # the factory's config record
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

    def _prepare_targets(self, y: np.ndarray) -> np.ndarray:
        if self.lookahead is None:
            return y
        if self.lookahead == 0:
            return windowing.reconstruction_targets(y, self.lookback_window)
        return windowing.forecast_targets(y, self.lookback_window, self.lookahead)

    def fit(self, X, y=None, **_kwargs) -> "BaseTorchEstimator":
        """Train a fresh model on ``X`` (targets ``y``, else ``X``) on the
        estimator's device; ``history_`` holds each epoch's loss. Works
        from a caller under ``no_grad`` or ``inference_mode`` too: the
        fit's tensors are ordinary ones, and grad mode (thread-local) is
        the caller's again afterwards. Under the numeric sanitizer while it
        is on (``utils.backend.nan_guard``)."""
        with torch.inference_mode(False), torch.enable_grad(), nan_guard():
            return self._fit(X, y)

    def _fit(self, X, y) -> "BaseTorchEstimator":
        started = time.perf_counter()
        X = _as_float32(X)
        y_arr = X if y is None else _as_float32(y)
        if X.ndim != 2:
            raise ValueError(f"Expected 2-D (rows, features) input, got {X.shape}")
        if len(y_arr) != len(X):
            raise ValueError(f"X and y row counts differ: {len(X)} vs {len(y_arr)}")
        device = resolve_device(self.device)
        self.n_features_ = int(X.shape[1])
        self.n_features_out_ = int(y_arr.shape[1])
        spec = self._make_spec(self.n_features_, self.n_features_out_)
        generator = torch.Generator().manual_seed(self.seed)
        module = init_flax_distributions(spec.module, generator).to(device)
        params = dict(module.named_parameters())

        def apply(p, x, gen):
            return torch.func.functional_call(module, p, (x,), {"generator": gen})

        fit_kwargs = dict(
            loss=spec.loss, batch_size=self.batch_size, epochs=self.epochs,
            use_dropout=float(spec.config.get("dropout", 0.0) or 0.0) > 0.0,
        )
        if self.lookahead is None:
            inputs, targets, w = pad_to_batches(X, self._prepare_targets(y_arr), self.batch_size)
            fit_fn = make_fit_fn(apply, spec.optimizer, **fit_kwargs)
        else:
            # windowed models train on window START indices; each batch
            # gathers its (batch, L, F) windows from the (n, F) rows
            L = self.lookback_window
            n_samples = windowing.n_windows(len(X), L, self.lookahead)
            if n_samples <= 0:
                raise ValueError(
                    f"Need at least lookback_window+lookahead={L + self.lookahead} rows "
                    f"to fit, got {len(X)}"
                )
            rows = torch.as_tensor(X, device=device)

            def windowed_apply(p, starts, gen):
                return apply(p, windowing.gather_windows(rows, starts, L), gen)

            inputs, targets, w = pad_to_batches(
                np.arange(n_samples), self._prepare_targets(y_arr), self.batch_size
            )
            fit_fn = make_fit_fn(windowed_apply, spec.optimizer, **fit_kwargs)
        result = fit_fn(
            params,
            *(torch.as_tensor(a, device=device) for a in (inputs, targets, w)),
            generator,
        )
        self.module_ = module.eval()
        self.architecture_ = spec.config
        self.params_ = flax_from_params(module)
        self.history_ = result.loss_history
        self.fit_duration_ = time.perf_counter() - started
        return self

    def score(self, X, y=None) -> float:
        """Explained variance of predictions against the contract-aligned
        targets (the reference's ``score``)."""
        self._check_fitted()
        X = _as_float32(X)
        y_arr = X if y is None else _as_float32(y)
        return explained_variance_score(self._prepare_targets(y_arr), self.predict(X))

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
        with torch.inference_mode(), nan_guard():
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

    def get_metadata(self) -> Dict[str, Any]:
        meta: Dict[str, Any] = {
            "type": type(self).__name__,
            "kind": self.kind,
            "batch_size": self.batch_size,
            "epochs": self.epochs,
            "parameters": dict(self.factory_kwargs),
        }
        if self.module_ is not None:
            meta.update(
                {
                    "history": {"loss": self.history_},
                    "architecture": self.architecture_,
                    "fit_duration_s": self.fit_duration_,
                    "num_parameters": int(sum(p.numel() for p in self.module_.parameters())),
                }
            )
        return meta

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
        self.architecture_ = spec.config
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

    def _prepare_targets(self, y: np.ndarray) -> np.ndarray:
        stacked = windowing.multi_step_targets(y, self.lookback_window, self.horizon)
        return stacked.reshape(stacked.shape[0], -1)

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
