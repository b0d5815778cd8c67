"""Training: optimizers and the train step, the counterpart of
``repro.train``."""
