"""End-to-end models of the port: the flagship TDOA pipeline and the
wideband config-4 pipeline."""
