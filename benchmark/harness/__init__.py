"""The port's benchmark: manifest, traffic, timed window, trace and check."""
