"""Dwell PSD (K7): the least work of the dwell-averaged power spectrum of
a dispatch.

Each row (channel × buoy) of K·N decoded samples (float32 re and im,
read once) is cut into K dwells of N points and transformed (5·N·log2(N)
FLOP a dwell); the power (3 FLOP a bin) is averaged over the dwells
(1 FLOP a bin) and the N-bin spectrum in dB (float32) written once.
"""

import math


def least(pipeline: dict, lead: tuple) -> tuple[float, float]:
    rows = math.prod(lead) * pipeline["num_buoys"]
    n, k = pipeline["block_len"], pipeline["correlation_dwells"]
    flops = rows * k * (5.0 * n * math.log2(n) + 4.0 * n)
    nbytes = rows * (8.0 * k * n + 4.0 * n)
    return flops, nbytes
