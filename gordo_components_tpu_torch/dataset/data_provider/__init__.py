"""Data providers of the port: fetch raw per-tag series for a time range as
numpy arrays (the port's copy of
``gordo_components_tpu/dataset/data_provider/``): the random, file and
composite providers."""

from .base import GordoBaseDataProvider
from .providers import (
    CompositeDataProvider,
    FileDataProvider,
    RandomDataProvider,
    provider_from_dict,
)

__all__ = [
    "GordoBaseDataProvider",
    "RandomDataProvider",
    "FileDataProvider",
    "CompositeDataProvider",
    "provider_from_dict",
]
