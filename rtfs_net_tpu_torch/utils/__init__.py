"""Host utilities of the port: ``separate`` and the JAX-variables converter."""
