"""End-to-end models of the port: the flagship TDOA pipeline (single dwell,
narrowband multi-dwell, complex-IQ step), the wideband config-4 pipeline
and the streaming model."""
