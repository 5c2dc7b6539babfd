"""Data providers of the port: fetch raw per-tag series for a time range as
numpy arrays (the port's copy of
``gordo_components_tpu/dataset/data_provider/``): the random, file, Influx,
flaky and composite providers, and the data-lake readers."""

from .base import GordoBaseDataProvider
from .ncs_iroc import DataLakeProvider, IrocReader, NcsReader
from .providers import (
    CompositeDataProvider,
    FileDataProvider,
    FlakyDataProvider,
    InfluxDataProvider,
    RandomDataProvider,
    provider_from_dict,
)

__all__ = [
    "GordoBaseDataProvider",
    "RandomDataProvider",
    "FileDataProvider",
    "InfluxDataProvider",
    "FlakyDataProvider",
    "CompositeDataProvider",
    "NcsReader",
    "IrocReader",
    "DataLakeProvider",
    "provider_from_dict",
]
