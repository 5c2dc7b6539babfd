"""Prediction forwarders (the port's copy of
``gordo_components_tpu/client/forwarders.py:22-72``): where
:meth:`~.client.Client.predict` hands each machine's scores.

A forwarder gets a :class:`~.client.ScoredFrame` and writes the columns of
the reference's score frame (``tag-anomaly-score-<i>`` per tag, then
``total-anomaly-score``, as float64) at the frame's timestamps:
:class:`CsvForwarder` as one CSV per machine with the reference's header
and formatting (an unnamed timestamp column in pandas' ``to_csv`` form,
floats in their shortest round-trip form), so either package's reader sees
the same table; :class:`ForwardPredictionsIntoInflux` as Influx points
tagged ``machine=<name>`` through
:class:`~gordo_components_tpu_torch.dataset.data_provider.influx_client.MinimalInfluxClient`
(or an injected client with its ``write_points``).
"""

from __future__ import annotations

import abc
import csv
import logging
import os
from typing import Any

from .. import wire

logger = logging.getLogger(__name__)


class PredictionForwarder(abc.ABC):
    @abc.abstractmethod
    def forward(self, machine: str, predictions: Any) -> None:
        """Deliver one machine's :class:`~.client.ScoredFrame`."""


class CsvForwarder(PredictionForwarder):
    """One CSV per machine under ``output_dir``, appended to on repeat
    calls (the header written once)."""

    def __init__(self, output_dir: str):
        self.output_dir = output_dir

    def forward(self, machine: str, predictions: Any) -> None:
        os.makedirs(self.output_dir, exist_ok=True)
        path = os.path.join(self.output_dir, f"{machine}.csv")
        header = not os.path.exists(path)
        # pandas writes a tz-aware index as "YYYY-MM-DD HH:MM:SS[.ffffff]+00:00"
        # and no index as 0..n-1; a NaN as an empty field
        if predictions.timestamps is None:
            index = [str(i) for i in range(len(predictions))]
        else:
            index = [t.replace("T", " ") for t in wire.iso_timestamps(predictions.timestamps)]
        with open(path, "a", newline="") as fh:
            writer = csv.writer(fh, lineterminator="\n")
            if header:
                writer.writerow(["", *predictions.columns])
            for stamp, row in zip(index, predictions.values.tolist()):
                writer.writerow([stamp, *("" if v != v else repr(v) for v in row)])
        logger.info("Forwarded %d rows for %s -> %s", len(predictions), machine, path)


class ForwardPredictionsIntoInflux(PredictionForwarder):
    """Scores into InfluxDB, one point per row in ``measurement``, tagged
    ``machine=<name>``. The client is the injected ``client`` (tests,
    pre-authenticated sessions), else a ``MinimalInfluxClient`` over
    ``influx_config``; the ``influxdb`` package is never imported."""

    def __init__(self, measurement: str = "anomaly", client: Any = None, **influx_config: Any):
        from ..dataset.data_provider.influx_client import MinimalInfluxClient

        self.measurement = measurement
        self._client = client if client is not None else MinimalInfluxClient(**influx_config)

    def forward(self, machine: str, predictions: Any) -> None:
        if predictions.timestamps is None:
            raise ValueError(f"{machine}: Influx points need timestamps; the scores have none")
        self._client.write_points(predictions.values, predictions.columns,
                                  predictions.timestamps, self.measurement,
                                  tags={"machine": machine})
