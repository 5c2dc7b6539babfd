"""Serving of the port: the scoring engine and the HTTP front."""
