"""Activation table and dtype resolution (port of
``gordo_components_tpu/models/modules.py:26-54``).

Activations keep flax's definitions, which differ from PyTorch's defaults
in one place: flax's ``gelu`` is the tanh approximation.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F

_ACTIVATIONS: dict = {
    "linear": lambda x: x,
    "tanh": torch.tanh,
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "elu": F.elu,
    "selu": F.selu,
    "softplus": F.softplus,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
}


def activation(name: str) -> Callable:
    """Resolve a Keras-style activation name."""
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"Unknown activation {name!r}; supported: {sorted(_ACTIVATIONS)}"
        ) from None


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(
            f"Unsupported compute_dtype {dtype!r}; supported: {sorted(_DTYPES)}"
        ) from None
