"""Host-side process parallelism without JAX."""
