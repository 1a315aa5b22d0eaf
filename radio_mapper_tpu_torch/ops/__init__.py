"""Operators of the ported slice: decode, planning tables, selection,
detection tail, GCC peak tail, and the CUDA kernels under :mod:`.cuda`."""
