"""Plain PyTorch references of the configurations the benchmark runs."""
