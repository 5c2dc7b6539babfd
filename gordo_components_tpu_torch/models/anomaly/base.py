"""Anomaly-detector contract: the reference's ``AnomalyDetectorBase``
(``gordo_components_tpu/models/anomaly/base.py``). An anomaly detector is
an estimator whose ``anomaly(X, y)`` returns per-row scores aligned to the
input rows (in the port an :class:`~.diff.AnomalyFrame`, not a pandas
frame: the card's host has no pandas)."""

from __future__ import annotations

import abc

from ..base import GordoBase


class AnomalyDetectorBase(GordoBase):
    @abc.abstractmethod
    def anomaly(self, X, y=None):
        """Per-row anomaly frame: model input/output, per-tag scaled errors,
        and the total anomaly score."""
