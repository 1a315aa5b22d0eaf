"""Network layer: the rtl_tcp wire protocol, the RTL2832U USB driver and
its register-level dongle model (port of ``radio_mapper_tpu/net``)."""
