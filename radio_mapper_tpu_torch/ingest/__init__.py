"""IQ ingest: the sources, the native ring and the ingest-closed loop.

Port of ``radio_mapper_tpu/ingest``. Every source yields complex64 blocks
at a known sample rate and can be retuned, so the node runtime and the
pipeline do not care where samples come from:

- :class:`SimulatedSource`: deterministic streams of a
  :mod:`radio_mapper_tpu_torch.sim` scenario (the hardware-free path);
- :class:`FileSource`: loops a raw uint8 I/Q ``.bin`` capture;
- :class:`RtlSdrProcessSource`: a persistent ``rtl_sdr`` subprocess;
- the C++ ring (``native/``) through
  :class:`radio_mapper_tpu_torch.ingest.native.NativeRingSource`, and
  :class:`radio_mapper_tpu_torch.ingest.runner.IngestLoop`, which feeds a
  pipeline step on the card from it.
"""

from radio_mapper_tpu_torch.ingest.sources import (
    FileSource,
    IQSource,
    RtlSdrProcessSource,
    SimulatedSource,
)

__all__ = ["IQSource", "SimulatedSource", "FileSource", "RtlSdrProcessSource"]
