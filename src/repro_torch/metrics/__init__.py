"""Metrics of the port (its own copy of ``repro.metrics``)."""
