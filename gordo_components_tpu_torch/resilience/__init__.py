"""Deadlines, admission, per-machine quarantine, fault points and the
client's circuit breakers (copies of the JAX package's ``resilience/``
modules)."""
