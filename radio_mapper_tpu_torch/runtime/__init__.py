"""Compute bodies of the runtime services (the services themselves stay
in the JAX package)."""
