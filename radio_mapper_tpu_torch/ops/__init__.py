"""Operators of the ported slices: decode, planning tables, selection,
detection (fused tail and natural order), windows and spectral helpers,
the complex GCC family and its peak tail, channelizer, the routed FFT
(split and complex) and split-complex GCC, and the CUDA kernels under
:mod:`.cuda`."""
