"""Models of the port (``repro.models`` counterparts)."""
