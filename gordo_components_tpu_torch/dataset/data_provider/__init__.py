"""Data providers of the port: fetch raw per-tag series for a time range as
numpy arrays (the port's copy of
``gordo_components_tpu/dataset/data_provider/``): the random, file, flaky
and composite providers."""

from .base import GordoBaseDataProvider
from .providers import (
    CompositeDataProvider,
    FileDataProvider,
    FlakyDataProvider,
    RandomDataProvider,
    provider_from_dict,
)

__all__ = [
    "GordoBaseDataProvider",
    "RandomDataProvider",
    "FileDataProvider",
    "FlakyDataProvider",
    "CompositeDataProvider",
    "provider_from_dict",
]
