"""Deadlines, admission and per-machine quarantine of the port's server
(copies of the JAX package's ``resilience/`` modules)."""
