"""Data generators of the port (its own copy of ``repro.data``)."""
