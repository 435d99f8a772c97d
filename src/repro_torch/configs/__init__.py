"""Model configurations of the port (its own copies of ``repro.configs``)."""
