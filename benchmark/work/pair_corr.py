"""Four-step pair stage ("spectra" + "pair_corr"): the least work of the
coherent all-pairs GCC of a dispatch.

Each channel's B captures of K·N samples (float32 re and im, read once)
are zero-padded to the 5-smooth nfft and transformed (5·nfft·log2(nfft)
FLOP a buoy); each of the B(B−1)/2 pairs forms R = X·conj(Y) (6 FLOP a
bin; the whitening is not counted), an inverse FFT pruned to the 2L+1
window lags (5·nfft·log2(2L+1)) and |r| (3 FLOP a lag), and writes its
window (float32) once.
"""

import math

from reference.tdoa import smooth_nfft


def least(pipeline: dict, lead: tuple) -> tuple[float, float]:
    blocks = math.prod(lead)
    b = pipeline["num_buoys"]
    pairs = blocks * b * (b - 1) // 2
    length = pipeline["block_len"] * pipeline["correlation_dwells"]
    nfft = smooth_nfft(length + pipeline["max_lag"])
    width = 2 * pipeline["max_lag"] + 1
    flops = blocks * b * 5.0 * nfft * math.log2(nfft) + pairs * (
        6.0 * nfft + 5.0 * nfft * math.log2(width) + 3.0 * width)
    nbytes = blocks * b * 8.0 * length + pairs * 4.0 * width
    return flops, nbytes
