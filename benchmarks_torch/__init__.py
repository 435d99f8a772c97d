"""The paper's benchmark harness, ported to PyTorch (``benchmarks`` is the
JAX reference's).  One module per table or figure, the reference's module
names; ``python -m benchmarks_torch.run`` runs them.  Imports ``torch``,
numpy, the stdlib and ``repro_torch``: never ``jax``, ``repro`` or
``benchmarks``."""
