"""The bulk prediction client of the port (copy of
``gordo_components_tpu/client/``): ``Client.predict(start, end)`` over a
server's ``?start&end`` fetches, and the forwarders that take its scores."""

from .client import Client, ClientError, QuotaExceeded, ScoredFrame
from .forwarders import CsvForwarder, ForwardPredictionsIntoInflux, PredictionForwarder
from .utils import make_date_ranges

__all__ = [
    "Client",
    "ClientError",
    "QuotaExceeded",
    "ScoredFrame",
    "PredictionForwarder",
    "CsvForwarder",
    "ForwardPredictionsIntoInflux",
    "make_date_ranges",
]
