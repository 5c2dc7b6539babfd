"""The port's command line (``build`` and ``rollback``)."""
