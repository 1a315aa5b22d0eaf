"""End-to-end models of the port: the flagship TDOA pipeline (single dwell
and narrowband multi-dwell) and the wideband config-4 pipeline."""
