"""radio_mapper_tpu_torch — the TDOA pipelines in PyTorch with CUDA kernels.

A port of slices of :mod:`radio_mapper_tpu` (JAX/Pallas on a TPU) to
PyTorch on an NVIDIA H100, with the module layout of the JAX package, so
each counterpart sits at the same path:

- the flagship step (:mod:`.models.pipeline`, ``TDOAPipeline``): uint8
  IQ decode → fused forward FFT + spectral detection (kernel K1,
  :mod:`.ops.cuda.fft_detect`) → all-pairs GCC pair stage (K2,
  :mod:`.ops.cuda.gcc_pair`, PHAT under the l2rx/l2/l1 gates or "cc") →
  sub-sample τ → LM hyperbolic solve; and the reference's other
  single-dwell routes: the per-channel megakernel (K8,
  :mod:`.ops.cuda.channel_step`), the two-kernel detect (K3 then K4,
  :mod:`.ops.cuda.detect_ct`), the natural-order detect on the CT
  spectra, and the natural-order split GCC;
- the wideband config-4 step (:mod:`.models.wideband`,
  ``WidebandTDOAPipeline``): polyphase channelizer → CT-order FFT of
  every subchannel's receivers (K3, :mod:`.ops.cuda.fft_rows`) → pair
  stage with the pair list as data (K5) or on pre-gathered rows (K6),
  both in :mod:`.ops.cuda.gcc_pair` → LM solve batched over subchannels;
- the narrowband multi-dwell step (``TDOAPipeline`` with
  ``correlation_dwells > 1``): dwell-averaged PSD through the
  natural-order FFT (K7, :mod:`.ops.cuda.fft_natural`, routed by
  :mod:`.ops.fft`) → natural-order detection → one coherent all-pairs
  GCC over the whole capture → multi-start LM; and the buoy's detection
  dwell (:mod:`.runtime.buoy_detect`) on the same FFT and detector;
- the complex-IQ paths: ``TDOAPipeline.step``/``step_uint8`` on complex64
  input (the power spectrum through K7 at 16384, 32768, 65536 points →
  natural-order detection → the complex all-pairs GCC of
  :mod:`.ops.gcc_phat` → LM), the streaming model
  (:mod:`.models.streaming_tdoa`: overlap-save channelizer → per-subchannel
  GCC → LM) and the central node's TDOA engine
  (:mod:`.runtime.tdoa_engine`: waveform and timestamp measurements →
  multi-start LM → latitude and longitude);
- the node and service side: the ingest loop (:mod:`.ingest`), the buoy
  service and the central service (:mod:`.runtime.buoy`,
  :mod:`.runtime.central`);
- the receiver tools: demodulators (:mod:`.ops.demod`), ADS-B
  (:mod:`.ops.adsb`) and the power scan (:mod:`.tools.power_scan`); and
  the command line, ``python -m radio_mapper_tpu_torch`` (:mod:`.cli`);
- the host side of the receiver: the RTL2832U USB driver and its
  register-level dongle model (:mod:`.net.usb_proto`,
  :mod:`.net.rtl2832u_model`), rtl_tcp (:mod:`.net.rtl_tcp`), rtl_test
  and rtl_eeprom (:mod:`.tools.sdr_test`, :mod:`.tools.eeprom`), the
  config system (:mod:`.config`), the offline analyzer (:mod:`.analyzer`)
  and the dashboard (:mod:`.webapp`).

Each kernel is CUDA C++ under ``csrc/`` with a plain PyTorch version
beside it. The package imports ``torch`` and numpy only; it never
imports JAX. Its pipelines run on the card unless the caller passes
``device="cpu"``.
"""

from radio_mapper_tpu_torch.version import __version__
