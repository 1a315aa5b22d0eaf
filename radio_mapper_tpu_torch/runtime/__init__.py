"""The runtime services: the buoy node and its detection dwell, the
central service and its TDOA engine, GPS time, the wire datamodel and the
emergency alerter."""
