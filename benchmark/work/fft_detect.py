"""pad + K1: the least work of the FFT and detect stage of a dispatch.

Each of the dispatch's rows (channel-blocks × buoys) of N decoded
samples (float32 re and im, read once) is zero-padded to nfft and
transformed (5·nfft·log2(nfft) FLOP, the radix-2 count), and the detect
body reads its power (3 FLOP a bin) and a running maximum (3 compares a
bin, van Herk / Gil-Werman); the spectra (float32 re and im), the
8-bin segment partials (a float32 value and offset a segment), the noise
floor and the row maximum are written once.
"""

import math

from reference.tdoa import ct_nfft


def least(pipeline: dict, lead: tuple) -> tuple[float, float]:
    rows = math.prod(lead) * pipeline["num_buoys"]
    n = pipeline["block_len"]
    nfft = ct_nfft(n + pipeline["max_lag"])
    flops = rows * (5.0 * nfft * math.log2(nfft) + 6.0 * nfft)
    nbytes = rows * (8.0 * n + 8.0 * nfft + 8.0 * (nfft // 8) + 8.0)
    return flops, nbytes
