"""Anomaly detectors of the port."""

from .diff import DiffBasedAnomalyDetector  # noqa: F401
