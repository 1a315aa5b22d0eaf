"""Compute bodies of the runtime services: the buoy's detection dwell and
the central node's TDOA engine (the services around them stay in the JAX
package)."""
