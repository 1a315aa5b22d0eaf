"""Host utilities of the central service: metrics and persistence."""
