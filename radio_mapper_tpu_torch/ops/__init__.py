"""Operators of the ported slices: decode, planning tables, selection,
detection (fused tail and natural order), spectral helpers, GCC peak
tail, channelizer, the routed FFT and split-complex GCC, and the CUDA
kernels under :mod:`.cuda`."""
