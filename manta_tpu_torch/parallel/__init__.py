"""Host-side process parallelism."""
