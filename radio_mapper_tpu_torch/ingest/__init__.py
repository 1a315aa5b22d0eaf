"""IQ ingest: the sources, the native ring and the ingest-closed loop.

Port of ``radio_mapper_tpu/ingest``. Every source yields complex64 blocks
at a known sample rate and can be retuned, so the node runtime and the
pipeline do not care where samples come from:

- :class:`SimulatedSource`: deterministic streams of a
  :mod:`radio_mapper_tpu_torch.sim` scenario (the hardware-free path);
- :class:`FileSource`: loops a raw uint8 I/Q ``.bin`` capture;
- :class:`RtlSdrProcessSource`: a persistent ``rtl_sdr`` subprocess;
- :class:`Rtl2832uSource`: the in-process USB driver
  (:mod:`radio_mapper_tpu_torch.net.usb_proto`) on any transport, the
  register-level dongle model included;
- :class:`~radio_mapper_tpu_torch.net.rtl_tcp.RtlTcpSource`: a client of
  the rtl_tcp wire protocol;
- the C++ ring (``native/``) through
  :class:`radio_mapper_tpu_torch.ingest.native.NativeRingSource`, and
  :class:`radio_mapper_tpu_torch.ingest.runner.IngestLoop`, which feeds a
  pipeline step on the card from it.
"""

from radio_mapper_tpu_torch.ingest.sources import (
    FileSource,
    IQSource,
    Rtl2832uSource,
    RtlSdrProcessSource,
    SimulatedSource,
)

__all__ = ["IQSource", "SimulatedSource", "FileSource", "RtlSdrProcessSource",
           "Rtl2832uSource"]
