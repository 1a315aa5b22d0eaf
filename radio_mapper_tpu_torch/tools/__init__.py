"""Tools of the port: the power scan (rtl_power parity), the SDR health
check (rtl_test), the EEPROM image codec (rtl_eeprom) and the
measurement scripts that run on the card."""
