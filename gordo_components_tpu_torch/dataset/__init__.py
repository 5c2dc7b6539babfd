"""The dataset layer of the port, in numpy (copy of
``gordo_components_tpu/dataset/``): sensor tags, data providers, and the
time-series assembly that hands float32 rows to the builder."""

from .base import GordoBaseDataset
from .dataset import InsufficientDataError, RandomDataset, TimeSeriesDataset, join_timeseries
from .sensor_tag import SensorTag, normalize_sensor_tags

__all__ = [
    "GordoBaseDataset",
    "InsufficientDataError",
    "TimeSeriesDataset",
    "RandomDataset",
    "join_timeseries",
    "SensorTag",
    "normalize_sensor_tags",
]
