"""End-to-end models of the port (the flagship TDOA pipeline)."""
