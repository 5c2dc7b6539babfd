"""Small shared helpers of the port (device resolution)."""
