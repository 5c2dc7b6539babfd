"""LSTM autoencoder / forecast factories (port of
``gordo_components_tpu/models/factories/lstm.py:20-166``).

``lstm_model`` (explicit units), ``lstm_symmetric`` (dims then mirrored)
and ``lstm_hourglass`` (the feedforward twins' dims math). One graph
serves ``LSTMAutoEncoder`` and ``LSTMForecast``; the estimator picks the
target contract.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from ..modules import LSTMModule
from ..register import register_model_factory
from .feedforward import _broadcast_funcs, _reject_unknown, hourglass_calc_dims
from .spec import ModelSpec, make_optimizer


def _build(
    n_features: int,
    n_features_out: Optional[int],
    lookback_window: int,
    units: Sequence[int],
    funcs,
    dropout: float,
    out_func: str,
    optimizer: str,
    optimizer_kwargs: Optional[Dict[str, Any]],
    loss: str,
    compute_dtype: str,
) -> ModelSpec:
    if lookback_window < 1:
        raise ValueError(f"lookback_window must be >= 1, got {lookback_window}")
    n_features_out = n_features_out or n_features
    resolved_funcs = _broadcast_funcs(funcs, units, "tanh")
    module = LSTMModule(
        n_features=n_features,
        units=tuple(units),
        n_features_out=n_features_out,
        funcs=resolved_funcs,
        out_func=out_func,
        compute_dtype=compute_dtype,
        dropout=dropout,
    )
    config = {
        "n_features": n_features,
        "n_features_out": n_features_out,
        "lookback_window": lookback_window,
        "units": list(units),
        "funcs": list(resolved_funcs),
        "dropout": dropout,
        "out_func": out_func,
        "optimizer": optimizer,
        "optimizer_kwargs": dict(optimizer_kwargs or {}),
        "loss": loss,
        "compute_dtype": compute_dtype,
    }
    return ModelSpec(
        module=module,
        optimizer=make_optimizer(optimizer, optimizer_kwargs),
        loss=loss,
        input_kind="window",
        config=config,
    )


@register_model_factory("lstm_model")
def lstm_model(
    n_features: int,
    n_features_out: Optional[int] = None,
    lookback_window: int = 1,
    units: Sequence[int] = (128, 64, 64, 128),
    funcs=None,
    dropout: float = 0.0,
    out_func: str = "linear",
    optimizer: str = "Adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    loss: str = "mse",
    compute_dtype: str = "float32",
    **unknown: Any,
) -> ModelSpec:
    """Explicit per-layer LSTM units — the reference's base LSTM factory."""
    _reject_unknown("lstm_model", unknown)
    return _build(
        n_features, n_features_out, lookback_window, units, funcs, dropout,
        out_func, optimizer, optimizer_kwargs, loss, compute_dtype,
    )


@register_model_factory("lstm_symmetric")
def lstm_symmetric(
    n_features: int,
    n_features_out: Optional[int] = None,
    lookback_window: int = 1,
    dims: Sequence[int] = (128, 64),
    funcs=None,
    dropout: float = 0.0,
    out_func: str = "linear",
    optimizer: str = "Adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    loss: str = "mse",
    compute_dtype: str = "float32",
    **unknown: Any,
) -> ModelSpec:
    """Encoder ``dims`` then mirrored decoder dims."""
    _reject_unknown("lstm_symmetric", unknown)
    if not dims:
        raise ValueError("dims must contain at least one layer size")
    encoding_funcs = _broadcast_funcs(funcs, dims, "tanh")
    return _build(
        n_features, n_features_out, lookback_window,
        tuple(dims) + tuple(reversed(dims)),
        encoding_funcs + tuple(reversed(encoding_funcs)), dropout, out_func,
        optimizer, optimizer_kwargs, loss, compute_dtype,
    )


@register_model_factory("lstm_hourglass")
def lstm_hourglass(
    n_features: int,
    n_features_out: Optional[int] = None,
    lookback_window: int = 1,
    encoding_layers: int = 3,
    compression_factor: float = 0.5,
    func: str = "tanh",
    dropout: float = 0.0,
    out_func: str = "linear",
    optimizer: str = "Adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    loss: str = "mse",
    compute_dtype: str = "float32",
    **unknown: Any,
) -> ModelSpec:
    """Hourglass dims mirrored into a symmetric LSTM stack."""
    _reject_unknown("lstm_hourglass", unknown)
    dims = hourglass_calc_dims(compression_factor, encoding_layers, n_features)
    return _build(
        n_features, n_features_out, lookback_window, dims + tuple(reversed(dims)),
        func, dropout, out_func, optimizer, optimizer_kwargs, loss, compute_dtype,
    )
