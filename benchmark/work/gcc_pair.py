"""K2 + lag pick: the least work of the pair stage of a dispatch.

Each channel-block's B receiver spectra (float32 re and im at nfft) and
row maxima are read once; each of its B(B−1)/2 pairs forms R = X·conj(Y)
(6 FLOP a bin; the whitening is not counted), an inverse FFT pruned to
the 2L+1 window lags (5·nfft·log2(2L+1)) and |r| (3 FLOP a lag); the lag
pick writes four float32 numbers a pair.
"""

import math

from reference.tdoa import ct_nfft


def least(pipeline: dict, lead: tuple) -> tuple[float, float]:
    blocks = math.prod(lead)
    b = pipeline["num_buoys"]
    pairs = blocks * b * (b - 1) // 2
    nfft = ct_nfft(pipeline["block_len"] + pipeline["max_lag"])
    width = 2 * pipeline["max_lag"] + 1
    flops = pairs * (6.0 * nfft + 5.0 * nfft * math.log2(width) + 3.0 * width)
    nbytes = blocks * b * (8.0 * nfft + 4.0) + pairs * 16.0
    return flops, nbytes
