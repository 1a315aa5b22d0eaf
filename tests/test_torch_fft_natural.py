"""The natural-order FFT: kernel K7's plain version and the routed
``fft_re_im``, vs the JAX package.

- K7: the port's plain version vs ``fft_kernel.fft_rows`` in Pallas
  interpret mode under ``fft.set_precision("highest")`` (the module
  default HIGH runs explicit bf16x3 products even in interpret mode; the
  port computes in float32). Tolerance 1e-5 of each row's max |X|: the
  same four-step float32 math on bit-identical tables, summed in another
  order.
- ``fft_re_im`` on the CPU is the reference's matmul four-step
  ``_fft_re_im`` (what JAX runs on the CPU too): the same 1e-5 against
  it and against float64 ``np.fft``.
- The routing and the copied tables, exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radio_mapper_tpu.ops import fft as jfft
from radio_mapper_tpu.ops.pallas import fft_kernel

from radio_mapper_tpu_torch.ops import fft as fft_ops
from radio_mapper_tpu_torch.ops.cuda import fft_natural
from radio_mapper_tpu_torch.testing import cap_cpu_threads

from test_torch_cuda import tone_rows

cap_cpu_threads()


def _assert_rows_close(out, ref, rel=1e-5):
    """(re, im) within ``rel`` of each row's max |X| of ``ref``."""
    ore, oim = (np.asarray(o, dtype=np.float64) for o in out)
    rre, rim = (np.asarray(r, dtype=np.float64) for r in ref)
    mag = np.sqrt(rre**2 + rim**2).max(axis=-1, keepdims=True)
    assert (np.abs(ore - rre).max(axis=-1, keepdims=True) <= rel * mag).all()
    assert (np.abs(oim - rim).max(axis=-1, keepdims=True) <= rel * mag).all()


@pytest.fixture
def jax_highest():
    assert jfft.get_precision() == jfft._PRECISION_TABLE["high"]
    jfft.set_precision("highest")
    try:
        yield
    finally:
        jfft.set_precision("high")


@pytest.mark.parametrize("rows,n", [(3, 4096), (2, 16384)])
def test_plain_k7_matches_pallas_interpret(jax_highest, rows, n):
    re, im = tone_rows(rows, n, n % 97)
    ref = fft_kernel.fft_rows(jnp.asarray(re), jnp.asarray(im), interpret=True)
    ours = fft_natural.fft_rows(torch.from_numpy(re), torch.from_numpy(im))
    _assert_rows_close([o.numpy() for o in ours], ref)
    assert ours[0].shape == (rows, n)


@pytest.mark.parametrize("n", [16, 1000, 16875, 135000])
def test_fft_re_im_matches_jax_and_numpy(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))
    re, im = x.real.astype(np.float32), x.imag.astype(np.float32)
    ours = [o.numpy() for o in fft_ops.fft_re_im(torch.from_numpy(re), torch.from_numpy(im))]
    _assert_rows_close(ours, jfft._fft_re_im(jnp.asarray(re), jnp.asarray(im)))
    ref = np.fft.fft(re.astype(np.float64) + 1j * im.astype(np.float64))
    _assert_rows_close(ours, (ref.real, ref.imag))


def test_k7_plain_and_fft_re_im_agree_with_leading_axes():
    """[2, 3, n] rows in, the same shape out; K7's split (256·128) and the
    matmul four-step's (128·256) give the same spectrum."""
    re, im = tone_rows(6, 32768, 5)
    xr, xi = torch.from_numpy(re).reshape(2, 3, -1), torch.from_numpy(im).reshape(2, 3, -1)
    k7 = fft_natural.fft_rows(xr, xi)
    plain = fft_ops.fft_re_im(xr, xi)
    assert k7[0].shape == plain[0].shape == (2, 3, 32768)
    _assert_rows_close([o.reshape(6, -1).numpy() for o in k7], [o.reshape(6, -1).numpy() for o in plain])


def test_routing_table():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for n in (16384, 32768, 65536):
        assert fft_ops.route(n, cuda) == "k7", n
        assert fft_ops.route(n, cpu) == "plain", n
    for n in (1024, 4096, 17280, 135000):
        assert fft_ops.route(n, cuda) == "plain", n
    # the reference routes by the same condition on the TPU
    for n in (1024, 4096, 16384, 17280, 32768, 65536, 135000):
        assert fft_natural.lane_aligned(n) == fft_kernel.mosaic_compatible(n), n
        assert (fft_ops.route(n, cuda) == "k7") == (n >= jfft._PALLAS_MIN_N and jfft._pallas_supported(n))


@pytest.mark.parametrize("n", [4096, 16384, 32768, 65536, 17280, 1000])
def test_tables_equal_reference(n):
    assert fft_natural.split(n) == fft_kernel._split(n)
    for a, b in zip(fft_natural.constants(n), fft_kernel._constants(n)):
        np.testing.assert_array_equal(a, b)
    assert fft_ops.split_length(n) == jfft._split_length(n)
    n1, n2 = fft_ops.split_length(n)
    for a, b in zip(fft_ops.twiddle(n1, n2), jfft._twiddle(n1, n2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("min_len", [17, 1000, 16896, 131584, 262744])
def test_friendly_fft_len_equal(min_len):
    assert fft_ops.friendly_fft_len(min_len) == jfft.friendly_fft_len(min_len)


def test_k7_wrapper_rejects_bad_inputs():
    x = torch.zeros(2, 16384)
    with pytest.raises(ValueError):  # shapes differ
        fft_natural.fft_rows(x, torch.zeros(2, 4096))
    with pytest.raises(TypeError):
        fft_natural.fft_rows(x.double(), x.double())
    with pytest.raises(ValueError):  # not contiguous
        fft_natural.fft_rows(torch.zeros(16384, 2).t(), torch.zeros(16384, 2).t())
    with pytest.raises(ValueError):  # prime length: n1 = 1031 > 256
        fft_natural.fft_rows(torch.zeros(2, 1031), torch.zeros(2, 1031))
    with pytest.raises(ValueError):  # no device kernel
        fft_natural.fft_rows(x.to("meta"), x.to("meta"))
