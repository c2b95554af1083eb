"""Phase-0 estimates whose JAX package counterparts reach JAX."""
