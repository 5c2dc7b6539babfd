"""Numeric primitives of the port: windowing, scaling and attention
(counterparts of ``gordo_components_tpu.ops``)."""

from .windowing import (  # noqa: F401
    forecast_targets,
    gather_windows,
    n_windows,
    reconstruction_targets,
    sliding_windows,
    window_output_index,
)
from .scaling import (  # noqa: F401
    ScalerParams,
    fit_minmax,
    fit_standard,
    inverse_transform,
    transform,
)
