"""Feedforward autoencoder factories (port of
``gordo_components_tpu/models/factories/feedforward.py:19-206``).

``feedforward_model`` (explicit encoder/decoder dims),
``feedforward_symmetric`` (mirrored dims) and ``feedforward_hourglass``
(``compression_factor`` + ``encoding_layers`` via ``hourglass_calc_dims``),
with the reference's hyperparameter names, defaults, errors and ``config``
records, and the optimizer that ``optimizer``/``optimizer_kwargs`` name.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

from ..modules import DenseAutoencoderModule
from ..register import register_model_factory
from .spec import ModelSpec, make_optimizer


def _reject_unknown(kind: str, unknown: dict) -> None:
    """A misspelled hyperparameter must fail the build, not silently serve
    the default architecture."""
    if unknown:
        raise ValueError(
            f"Unknown hyperparameters for kind {kind!r}: {sorted(unknown)}"
        )


def _broadcast_funcs(funcs, dims, default: str) -> Tuple[str, ...]:
    if funcs is None:
        return tuple(default for _ in dims)
    if isinstance(funcs, str):
        return tuple(funcs for _ in dims)
    funcs = tuple(funcs)
    if len(funcs) != len(dims):
        raise ValueError(
            f"Got {len(funcs)} activation funcs for {len(dims)} layers"
        )
    return funcs


def hourglass_calc_dims(
    compression_factor: float, encoding_layers: int, n_features: int
) -> Tuple[int, ...]:
    """Linearly interpolated layer dims from ``n_features`` down to
    ``n_features * compression_factor`` over ``encoding_layers`` layers;
    ``(0.5, 3, 10) → (8, 7, 5)``."""
    if not 0 <= compression_factor <= 1:
        raise ValueError(
            f"compression_factor must be 0..1, got {compression_factor}"
        )
    if encoding_layers < 1:
        raise ValueError(f"encoding_layers must be >= 1, got {encoding_layers}")
    smallest = max(1, n_features * compression_factor)
    slope = (n_features - smallest) / encoding_layers
    return tuple(
        int(round(n_features - slope * i)) for i in range(1, encoding_layers + 1)
    )


def _build(
    n_features: int,
    n_features_out: Optional[int],
    encoding_dim: Sequence[int],
    encoding_func,
    decoding_dim: Sequence[int],
    decoding_func,
    out_func: str,
    optimizer: str,
    optimizer_kwargs: Optional[Dict[str, Any]],
    loss: str,
    compute_dtype: str,
) -> ModelSpec:
    n_features_out = n_features_out or n_features
    encoding_funcs = _broadcast_funcs(encoding_func, encoding_dim, "tanh")
    decoding_funcs = _broadcast_funcs(decoding_func, decoding_dim, "tanh")
    module = DenseAutoencoderModule(
        n_features=n_features,
        encoding_dims=tuple(encoding_dim),
        decoding_dims=tuple(decoding_dim),
        n_features_out=n_features_out,
        encoding_funcs=encoding_funcs,
        decoding_funcs=decoding_funcs,
        out_func=out_func,
        compute_dtype=compute_dtype,
    )
    config = {
        "n_features": n_features,
        "n_features_out": n_features_out,
        "encoding_dim": list(encoding_dim),
        "encoding_func": list(encoding_funcs),
        "decoding_dim": list(decoding_dim),
        "decoding_func": list(decoding_funcs),
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
        input_kind="flat",
        config=config,
    )


@register_model_factory("feedforward_model")
def feedforward_model(
    n_features: int,
    n_features_out: Optional[int] = None,
    encoding_dim: Sequence[int] = (256, 128, 64),
    encoding_func=None,
    decoding_dim: Sequence[int] = (64, 128, 256),
    decoding_func=None,
    out_func: str = "linear",
    optimizer: str = "Adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    loss: str = "mse",
    compute_dtype: str = "float32",
    **unknown: Any,
) -> ModelSpec:
    """Explicit encoder/decoder dims — the reference's base factory."""
    _reject_unknown("feedforward_model", unknown)
    return _build(
        n_features, n_features_out, encoding_dim, encoding_func, decoding_dim,
        decoding_func, out_func, optimizer, optimizer_kwargs, loss, compute_dtype,
    )


@register_model_factory("feedforward_symmetric")
def feedforward_symmetric(
    n_features: int,
    n_features_out: Optional[int] = None,
    dims: Sequence[int] = (256, 128, 64),
    funcs=None,
    out_func: str = "linear",
    optimizer: str = "Adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    loss: str = "mse",
    compute_dtype: str = "float32",
    **unknown: Any,
) -> ModelSpec:
    """Encoder ``dims``, decoder mirrored (reversed) automatically."""
    _reject_unknown("feedforward_symmetric", unknown)
    if not dims:
        raise ValueError("dims must contain at least one layer size")
    encoding_funcs = _broadcast_funcs(funcs, dims, "tanh")
    return _build(
        n_features, n_features_out, tuple(dims), encoding_funcs,
        tuple(reversed(dims)), tuple(reversed(encoding_funcs)), out_func,
        optimizer, optimizer_kwargs, loss, compute_dtype,
    )


@register_model_factory("feedforward_hourglass")
def feedforward_hourglass(
    n_features: int,
    n_features_out: Optional[int] = None,
    encoding_layers: int = 3,
    compression_factor: float = 0.5,
    func: str = "tanh",
    out_func: str = "linear",
    optimizer: str = "Adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    loss: str = "mse",
    compute_dtype: str = "float32",
    **unknown: Any,
) -> ModelSpec:
    """Hourglass: dims interpolate down to ``n_features * compression_factor``
    then mirror back up."""
    _reject_unknown("feedforward_hourglass", unknown)
    dims = hourglass_calc_dims(compression_factor, encoding_layers, n_features)
    return _build(
        n_features, n_features_out, dims, func, tuple(reversed(dims)), func,
        out_func, optimizer, optimizer_kwargs, loss, compute_dtype,
    )
