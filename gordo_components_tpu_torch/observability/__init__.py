"""Observability of the port (copies of the JAX package's
``observability/`` modules): the metrics registry and its Prometheus
exposition with exemplars, request trace ids, per-request span timelines,
the flight recorder, cross-process stitching, log setup and the control
ledger."""
