"""Observability of the port (copies of the JAX package's
``observability/`` modules): the metrics registry and its Prometheus
exposition with exemplars, request trace ids, per-request span timelines,
the flight recorder, cross-process stitching, log setup, the control
ledger, traffic accounting, the telemetry warehouse, the SLO engine and
the incident correlator."""
