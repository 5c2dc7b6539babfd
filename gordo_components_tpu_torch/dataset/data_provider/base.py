"""The data-provider contract (the port's copy of
``gordo_components_tpu/dataset/data_provider/base.py:1-58``), without
pandas.

A provider yields one ``(name, timestamps_ns, values)`` triple per
requested tag over the half-open ``[train_start_date, train_end_date)``:
``timestamps_ns`` an int64 array of UTC nanoseconds since the epoch (a
naive datetime reads as UTC), ``values`` a float64 array. Where the
reference yields a ``pd.Series``, the triple holds its name, its index's
``asi8`` and its values.
"""

from __future__ import annotations

import abc
from datetime import datetime, timezone
from typing import Any, Dict, Iterable, List, Tuple

import numpy as np

from ...utils.config import resolve_config_class
from ..sensor_tag import SensorTag

Series = Tuple[str, np.ndarray, np.ndarray]

_EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)


def datetime_to_ns(value: datetime) -> int:
    """UTC nanoseconds of ``value``; a naive datetime reads as UTC (its
    wall clock, as ``pd.Timestamp(value).value`` gives)."""
    if value.tzinfo is None:
        value = value.replace(tzinfo=timezone.utc)
    delta = value - _EPOCH
    return (delta.days * 86_400 + delta.seconds) * 1_000_000_000 + delta.microseconds * 1_000


class GordoBaseDataProvider(abc.ABC):
    @abc.abstractmethod
    def load_series(
        self,
        train_start_date: datetime,
        train_end_date: datetime,
        tag_list: List[SensorTag],
        dry_run: bool = False,
    ) -> Iterable[Series]:
        """Yield one ``(name, timestamps_ns, values)`` per tag over
        ``[start, end)``. ``dry_run`` checks availability without reading
        the bulk of the data."""

    @abc.abstractmethod
    def can_handle_tag(self, tag: SensorTag) -> bool:
        """Whether this provider knows how to read ``tag``."""

    def to_dict(self) -> Dict[str, Any]:
        """Serializable config; inverse of :meth:`from_dict`."""
        return {
            "type": f"{self.__class__.__module__}.{self.__class__.__name__}",
            **getattr(self, "_init_kwargs", {}),
        }

    @classmethod
    def from_dict(cls, config: Dict[str, Any]) -> "GordoBaseDataProvider":
        from . import providers

        config = dict(config)
        type_path = config.pop("type", None)
        if type_path is None:
            raise ValueError("Provider config requires a 'type' key")
        provider_cls = resolve_config_class(
            type_path, GordoBaseDataProvider, providers.PROVIDERS, providers.PROVIDER_MODULES)
        return provider_cls(**config)
