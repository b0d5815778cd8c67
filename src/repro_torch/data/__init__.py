"""Data: the deterministic synthetic token pipeline, the counterpart of
``repro.data``."""
