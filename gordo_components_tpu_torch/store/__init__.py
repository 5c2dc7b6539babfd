"""Artifact integrity for the port (manifest verification)."""
