"""Forward FFT of split-complex rows: direct DFT, matmul four-step, kernel K7;
and the complex ``fft``/``ifft``/``fftshift`` on top of it.

Port of ``radio_mapper_tpu/ops/fft.py``: ``dft_matrix``/``dft_direct``
(``_dft_matrix``/``_dft_direct``), ``twiddle`` (``_twiddle``),
``split_length`` (``_split_length``), the recursive matmul four-step
``fft_re_im_plain`` (``_fft_re_im``), ``friendly_fft_len``, the entry
point ``fft_re_im``, ``ifft_re_im`` (the reference's
``split_complex.ifft_re_im``), and ``fft``, ``ifft``, ``fftshift`` on the
plane split ``re_im``. The reference computes the direct DFT and the
four-step with XLA dots outside any Pallas kernel, so ``torch.matmul`` on
the same float32 tables is the port; the products are float32 unless the
caller has enabled TF32 (``torch.backends.cuda.matmul.allow_tf32``).

Routing (:func:`route`), a pure function of length and device, as the
reference routes on the TPU: on a CUDA tensor a length of at least 4096
whose K7 split has both factors multiples of 128 (16384, 32768, 65536)
goes to kernel K7 (:mod:`.cuda.fft_natural`); every other length, and
every CPU tensor, takes the matmul four-step.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from radio_mapper_tpu_torch.ops.cuda import fft_natural

MAX_DIRECT = 1024  # the reference's largest direct DFT
KERNEL_MIN_N = 4096  # fft._PALLAS_MIN_N: shorter rows take the matmul path


@functools.lru_cache(maxsize=None)
def dft_matrix(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(re, im) of the symmetric DFT matrix W[j,k] = exp(-2πi·jk/n), f32."""
    jk = np.outer(np.arange(n), np.arange(n))
    w = np.exp(-2j * np.pi * jk / n)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def twiddle(n1: int, n2: int) -> Tuple[np.ndarray, np.ndarray]:
    """(re, im) of T[n1, k2] = exp(-2πi·n1·k2/(n1·n2)), f32."""
    t = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / (n1 * n2))
    return t.real.astype(np.float32), t.imag.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _on(kind: str, dims: Tuple[int, ...], device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dft_matrix(*dims)`` or ``twiddle(*dims)`` on ``device``."""
    t_re, t_im = (dft_matrix if kind == "dft" else twiddle)(*dims)
    return torch.from_numpy(t_re).to(device), torch.from_numpy(t_im).to(device)


def split_length(n: int) -> Tuple[int, int]:
    """Pick N1 (outer, ≤ MAX_DIRECT, near √N) · N2 = N."""
    best = None
    n1 = 1
    while n1 * n1 <= n:
        if n % n1 == 0 and n1 <= MAX_DIRECT:
            best = n1
        n1 += 1
    if best is None or best == 1:
        raise ValueError(
            f"FFT length {n} has no usable factorization (needs a factor ≤ {MAX_DIRECT})"
        )
    return best, n // best


def dft_direct(re: torch.Tensor, im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward DFT over the last axis of a float32 (re, im) pair as one
    product with the n×n DFT matrix, n ≤ ``MAX_DIRECT``."""
    n = re.shape[-1]
    if n > MAX_DIRECT:
        raise ValueError(f"direct DFT of {n} > {MAX_DIRECT} points: use fft_re_im")
    w_re, w_im = _on("dft", (n,), re.device)
    return re @ w_re - im @ w_im, re @ w_im + im @ w_re


def fft_re_im_plain(re: torch.Tensor, im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward DFT over the last axis by the recursive matmul four-step
    (the reference's ``_fft_re_im``): N = N1·N2, inner DFT over n2
    (recursing until it is direct), twiddle, outer N1-point DFT."""
    n = re.shape[-1]
    if n <= MAX_DIRECT:
        return dft_direct(re, im)
    n1, n2 = split_length(n)
    batch = re.shape[:-1]
    # A[..., n1, n2] = x[n1 + N1·n2]: the inner DFT runs over the last axis
    a_re = re.reshape(*batch, n2, n1).transpose(-1, -2)
    a_im = im.reshape(*batch, n2, n1).transpose(-1, -2)
    b_re, b_im = fft_re_im_plain(a_re, a_im)  # [..., n1, k2]
    t_re, t_im = _on("twiddle", (n1, n2), re.device)
    c_re = b_re * t_re - b_im * t_im
    c_im = b_re * t_im + b_im * t_re
    # outer DFT over n1: R[..., k1, k2] = Σ_n1 W1[k1, n1] · C[..., n1, k2]
    w_re, w_im = _on("dft", (n1,), re.device)
    r_re = w_re @ c_re - w_im @ c_im
    r_im = w_re @ c_im + w_im @ c_re
    # flat index k = k2 + N2·k1: [k1, k2] row-major
    return r_re.reshape(*batch, n), r_im.reshape(*batch, n)


@functools.lru_cache(maxsize=None)
def friendly_fft_len(min_len: int) -> int:
    """Smallest 5-smooth (2^a·3^b·5^c) length ≥ min_len."""
    best = 1 << (int(min_len) - 1).bit_length()  # pow2 fallback
    p5 = 1
    while p5 < best:
        p3 = p5
        while p3 < best:
            p2 = p3
            while p2 < min_len:
                p2 *= 2
            if p2 < best:
                best = p2
            p3 *= 3
        p5 *= 5
    return best


def route(n: int, device: torch.device) -> str:
    """``"k7"`` or ``"plain"``: where :func:`fft_re_im` sends a row of
    ``n`` points on ``device`` (the reference's ``fft_re_im`` condition)."""
    if device.type == "cuda" and n >= KERNEL_MIN_N and fft_natural.lane_aligned(n):
        return "k7"
    return "plain"


def fft_re_im(re: torch.Tensor, im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split-representation forward FFT over the last axis, natural bin
    order. See :func:`route`."""
    re = re.to(torch.float32)
    im = im.to(torch.float32)
    if route(re.shape[-1], re.device) == "k7":
        return fft_natural.fft_rows(re.contiguous(), im.contiguous())
    return fft_re_im_plain(re, im)


def re_im(x: torch.Tensor, n: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contiguous float32 ``(re, im)`` planes of complex ``x [..., N]``,
    zero-padded or cut to ``n`` points."""
    re, im = x.real.to(torch.float32), x.imag.to(torch.float32)
    if n is None or n == x.shape[-1]:
        return re.contiguous(), im.contiguous()
    if n < x.shape[-1]:
        return re[..., :n].contiguous(), im[..., :n].contiguous()
    pad = lambda a: torch.nn.functional.pad(a, (0, n - x.shape[-1]))
    return pad(re), pad(im)


def ifft_re_im(re: torch.Tensor, im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split-representation inverse FFT over the last axis by the
    conjugation identity ``conj(fft(conj(x)))/N``, as the reference computes
    it on the TPU: the forward route (K7 where :func:`route` says so) runs
    the inverse too."""
    n = re.shape[-1]
    yre, yim = fft_re_im(re, -im)
    return yre / n, -yim / n


def fft(x: torch.Tensor, n: Optional[int] = None, axis: int = -1) -> torch.Tensor:
    """Complex forward FFT over one axis (zero-padded or cut to ``n``),
    complex64 out.

    The complex input is split into contiguous float32 planes (:func:`re_im`)
    and goes through :func:`fft_re_im`, so a CUDA tensor of a length
    :func:`route` sends to kernel K7 runs K7, and every other length (and
    every CPU tensor) the matmul four-step. The reference's ``fft`` under
    its default backend runs XLA's native FFT on the CPU and its matmul
    four-step on the TPU, and reaches its Pallas kernel only under
    ``set_backend("pallas")``; the results agree within float32 rounding.
    """
    if axis not in (-1, x.dim() - 1):
        return fft(x.movedim(axis, -1), n=n).movedim(-1, axis)
    return torch.complex(*fft_re_im(*re_im(x, n)))


def ifft(x: torch.Tensor, n: Optional[int] = None, axis: int = -1) -> torch.Tensor:
    """Complex inverse FFT over one axis (zero-padded or cut to ``n``) by
    :func:`ifft_re_im`."""
    if axis not in (-1, x.dim() - 1):
        return ifft(x.movedim(axis, -1), n=n).movedim(-1, axis)
    return torch.complex(*ifft_re_im(*re_im(x, n)))


def fftshift(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Zero frequency to the centre of ``axis`` (``np.fft.fftshift``)."""
    return torch.roll(x, x.shape[axis] // 2, dims=axis)
