"""The loops that run a traffic mix: ``run(cell, seed, seconds, tracer, device)``."""
