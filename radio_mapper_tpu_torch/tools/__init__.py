"""Tools of the port: the power scan (rtl_power parity) and the
measurement scripts that run on the card."""
