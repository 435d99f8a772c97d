"""Drivers and tools of the port (``repro.launch`` counterparts)."""
