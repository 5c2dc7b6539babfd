"""Metrics registry, Prometheus exposition and request trace ids of the
port (copies of the JAX package's ``observability/`` modules)."""
