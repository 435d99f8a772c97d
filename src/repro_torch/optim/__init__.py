"""Optimizers of the port (``repro.optim`` counterparts)."""
