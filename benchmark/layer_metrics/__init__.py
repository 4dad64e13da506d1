"""One reader per per-layer metric, ``<metric>.py`` with ``read(ctx)``."""
