"""Plain float32 references of the model families the port runs beyond the JAX package,
written from their published descriptions (no JAX, no import of the port)."""
