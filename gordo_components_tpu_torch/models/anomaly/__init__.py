"""Anomaly detectors of the port."""

from .base import AnomalyDetectorBase  # noqa: F401
from .diff import AnomalyFrame, DiffBasedAnomalyDetector  # noqa: F401
