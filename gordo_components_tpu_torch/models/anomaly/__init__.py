"""Anomaly detectors of the port."""

from .diff import AnomalyFrame, DiffBasedAnomalyDetector  # noqa: F401
