"""The writer-fleet wire protocol's machine-readable spec (``spec``)."""
