"""Output writers of the port (copies of the JAX package's numpy/pandas writers)."""
