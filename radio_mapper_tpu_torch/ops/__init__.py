"""Operators of the ported slices: decode, planning tables, selection,
detection tail, GCC peak tail, channelizer and short DFTs, and the CUDA
kernels under :mod:`.cuda`."""
