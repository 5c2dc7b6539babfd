"""The dataset contract (the port's copy of
``gordo_components_tpu/dataset/base.py:1-42``): ``get_data() -> (X, y)``
as float32 numpy arrays, ``get_metadata()``, and dict round trips, so
dataset configs embed in build metadata."""

from __future__ import annotations

import abc
from typing import Any, Dict, Tuple

import numpy as np

from ..utils.config import resolve_config_class


class GordoBaseDataset(abc.ABC):
    @abc.abstractmethod
    def get_data(self) -> Tuple[np.ndarray, np.ndarray]:
        """The feature matrix ``X`` and the target ``y``, row-aligned."""

    @abc.abstractmethod
    def get_metadata(self) -> Dict[str, Any]:
        """What the build records about the data (per-tag counts, ...)."""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "type": f"{self.__class__.__module__}.{self.__class__.__name__}",
            **getattr(self, "_init_kwargs", {}),
        }

    @classmethod
    def from_dict(cls, config: Dict[str, Any]) -> "GordoBaseDataset":
        from . import dataset

        config = dict(config)
        type_path = config.pop("type", "TimeSeriesDataset")
        dataset_cls = resolve_config_class(
            type_path, GordoBaseDataset, dataset.DATASETS, dataset.DATASET_MODULES)
        return dataset_cls(**config)
