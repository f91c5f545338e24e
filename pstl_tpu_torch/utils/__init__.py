"""Training utilities: meters and experiment directories."""
