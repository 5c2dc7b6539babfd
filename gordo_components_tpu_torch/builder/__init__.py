"""The port's builder (copy of ``gordo_components_tpu/builder/``)."""

from .build_model import build_model, calculate_model_key, provide_saved_model

__all__ = ["build_model", "calculate_model_key", "provide_saved_model"]
