"""Pure-function feature scaling (port of ``gordo_components_tpu/ops/scaling.py``).

``ScalerParams`` is an affine ``x * scale + offset``; one shape covers
minmax, standard and identity scaling. The fit functions work on numpy or
torch input and return tensors of the input's dtype and device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ScalerParams(NamedTuple):
    """Affine transform ``x * scale + offset``; inverse ``(x - offset)/scale``."""

    scale: torch.Tensor
    offset: torch.Tensor


def fit_minmax(
    x: torch.Tensor, feature_range: tuple = (0.0, 1.0), eps: float = 1e-12
) -> ScalerParams:
    """Per-feature min-max to ``feature_range`` (sklearn MinMaxScaler
    semantics: zero-range features map to the range minimum)."""
    x = torch.as_tensor(x)
    lo, hi = feature_range
    xmin = x.amin(dim=0)
    xmax = x.amax(dim=0)
    span = xmax - xmin
    scale = (hi - lo) / torch.where(span < eps, torch.ones_like(span), span)
    return ScalerParams(scale=scale, offset=lo - xmin * scale)


def fit_standard(x: torch.Tensor, eps: float = 1e-12) -> ScalerParams:
    """Per-feature standardization (sklearn StandardScaler semantics:
    zero-variance features are centered but not scaled). Population
    standard deviation, as ``jnp.std``."""
    x = torch.as_tensor(x)
    mean = x.mean(dim=0)
    std = x.std(dim=0, correction=0)
    scale = 1.0 / torch.where(std < eps, torch.ones_like(std), std)
    return ScalerParams(scale=scale, offset=-mean * scale)


def transform(params: ScalerParams, x: torch.Tensor) -> torch.Tensor:
    return x * params.scale + params.offset


def inverse_transform(params: ScalerParams, x: torch.Tensor) -> torch.Tensor:
    return (x - params.offset) / params.scale
