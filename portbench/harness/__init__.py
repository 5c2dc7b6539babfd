"""The benchmark harness: set-up, traffic, the measured window, the
comparison that decides ``correct``, and the yardstick's arithmetic."""
