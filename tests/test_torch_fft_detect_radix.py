"""Kernel K1's forward half (and K8's), replayed in numpy on the CPU.

K1 (``csrc/fft_detect.cu``) and K8 (``csrc/channel_step.cu``) run K3's
steps A, B and C (``csrc/ct_fft.cuh`` ``fft_power_row``) on a row of
n = 128·n2 samples, n2 = 8·r, and replace K3's store by a hand-off to the
detect body:

- warp w (of 16) takes the slot rows sr = w + 16·t; after step C lane l
  holds values j < 4 of positions 4l + j, whose CT address is row
  k2 = k + 8·s (sr = s + r·k), column k1 = brev2(j)·32 + brev5(l);
- it stores each value's spectrum there and keeps its power
  fr² + fi² in ``pv[4t + j]``, in registers (the slot rows are still
  being read by other warps);
- after a barrier it writes ``pv`` to ``pwr`` at the same CT address,
  over the row's first n floats, and the detect body runs on ``pwr``.

The replica below runs that schedule on K3's step-C registers
(``test_torch_fft_radix.k3_registers``) and checks that the map covers
each address once, that no thread holds more than 48 powers, that the
spectra are K3's and numpy's, and that the plain detect body on them
matches it on the plain K1's spectra within K1's limits.
"""

import numpy as np
import pytest
import torch

from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import fft_detect
from radio_mapper_tpu_torch.testing import cap_cpu_threads
from test_torch_cuda import DET, assert_partials_close, tone_rows
from test_torch_fft_radix import _bitrev, k3_registers, k3_schedule

cap_cpu_threads()

WARPS = 16  # ct_fft.cuh THREADS / 32
MAX_HELD = 48  # ct_fft.cuh HANDOFF_MAX_HELD
LENGTHS = [5120, 8192, 9216, 17408, 24576]  # r = 5, 8, 9, 17, 24


def handoff_rmax(r: int) -> int:
    """``rm_fft::handoff_rmax``: the step-B register tile K1 and K8 launch."""
    return 8 if r <= 8 else 16 if r <= 16 else 24 if r <= 24 else 0


def handoff_map(n: int):
    """``(addr, owner, slot)`` of every step-C value in the hand-off, each
    ``[n2, 32, 4]`` over (slot row, lane, value): its CT address, the
    thread (warp·32 + lane) that holds it, and its index in that thread's
    ``pv``."""
    n2, a, r = ct_plan.radix_split(n)
    sr = np.arange(n2)[:, None, None]
    lane = np.arange(32)[None, :, None]
    j = np.arange(4)[None, None, :]
    k, s = sr // r, sr % r
    k1 = np.array([_bitrev(i, 2) for i in range(4)])[j] * 32 + np.array([_bitrev(x, 5) for x in range(32)])[lane]
    addr = (k + a * s) * 128 + k1
    warp, t = sr % WARPS, sr // WARPS
    return addr, warp * 32 + lane + 0 * j, 4 * t + j + 0 * lane


def k1_handoff(x: np.ndarray):
    """K1's forward half on complex64 rows ``x [rows, n]``: ``(spectra,
    pwr)`` in CT order, each written through the hand-off's map."""
    rows, n = x.shape
    v = k3_registers(x)  # [rows, n2, 32, 4]
    addr, owner, slot = handoff_map(n)
    spec = np.full((rows, n), np.nan, np.complex64)
    spec[:, addr.reshape(-1)] = v.reshape(rows, -1)
    # held powers: pv[thread][slot], then the store after the barrier
    pv = np.full((rows, 512, MAX_HELD), np.nan, np.float32)
    re, im = v.real.astype(np.float32), v.imag.astype(np.float32)
    pv[:, owner.reshape(-1), slot.reshape(-1)] = (re * re + im * im).reshape(rows, -1)
    pwr = np.full((rows, n), np.nan, np.float32)
    pwr[:, addr.reshape(-1)] = pv[:, owner.reshape(-1), slot.reshape(-1)]
    return spec, pwr


def test_every_detect_length_k1_takes_has_a_radix_split_with_a_8():
    """Every nfft ``detect_plan`` accepts up to K1's ``MAX_N`` splits as
    n = 128·8·r with r ≤ 24, so K1's wrapper takes it with a register tile."""
    accepted = []
    for n in range(128, fft_detect.MAX_N + 1, 128):
        try:
            ct_plan.detect_plan(n, **DET)
        except ValueError:
            continue
        n2, a, r = ct_plan.radix_split(n)
        assert a == 8 and r <= 24, (n, a, r)
        assert fft_detect.radix_geometry(n) == (n2, a, r)
        assert handoff_rmax(r) in (8, 16, 24)
        accepted.append(n)
    assert len(accepted) >= 20 and accepted[-1] == fft_detect.MAX_N


@pytest.mark.parametrize("n", LENGTHS)
def test_handoff_map_covers_each_address_once(n):
    n2, _, r = ct_plan.radix_split(n)
    addr, owner, slot = handoff_map(n)
    np.testing.assert_array_equal(np.sort(addr.reshape(-1)), np.arange(n))
    # each thread's pv slots are distinct, and no thread holds more than 48
    key = owner.reshape(-1) * MAX_HELD + slot.reshape(-1)
    assert np.unique(key).size == n
    held = np.bincount(owner.reshape(-1), minlength=512)
    assert held.max() <= MAX_HELD
    assert slot.max() < 4 * (handoff_rmax(r) // 2) <= MAX_HELD  # pv[4·RMAX/2] in fft_power_row
    # a warp's 32 lanes write 32 consecutive floats for each (slot row, value)
    blocks = addr // 32
    assert (blocks == blocks[:, :1, :]).all()
    np.testing.assert_array_equal(np.sort(addr % 32, axis=1), np.broadcast_to(np.arange(32)[None, :, None], addr.shape))


def _rows(n, seed):
    re, im = tone_rows(4, n, seed, n_valid=n - n // 5)
    return re, im, (re + 1j * im).astype(np.complex64)


@pytest.mark.parametrize("n", LENGTHS)
def test_handoff_replica_spectra_are_k3s_and_powers_are_theirs(n):
    _, _, x = _rows(n, n + 1)
    spec, pwr = k1_handoff(x)
    np.testing.assert_array_equal(spec, k3_schedule(x))  # K1's spectra are K3's
    ref = np.fft.fft(x.astype(np.complex128))[..., ct_plan.ct_permutation(n)]
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    assert (np.abs(spec - ref).max(axis=-1, keepdims=True) <= 1e-5 * scale).all()
    fr, fi = spec.real.astype(np.float32), spec.imag.astype(np.float32)
    np.testing.assert_array_equal(pwr, fr * fr + fi * fi)  # K4's power on these spectra


@pytest.mark.parametrize("n", LENGTHS)
def test_detect_on_handoff_replica_matches_plain_k1(n):
    re, im, x = _rows(n, n + 2)
    plan = ct_plan.detect_plan(n, **DET)
    spec, _ = k1_handoff(x)
    fr = torch.from_numpy(np.ascontiguousarray(spec.real, dtype=np.float32))
    fi = torch.from_numpy(np.ascontiguousarray(spec.imag, dtype=np.float32))
    ours = fft_detect.detect_plain(fr, fi, plan)
    pfr, pfi, *ref = fft_detect.fft_detect_rows_ct_plain(torch.from_numpy(re), torch.from_numpy(im), plan)
    assert_partials_close(ours[:3], ref[:3], pfr, pfi, plan)
    np.testing.assert_allclose(ours[3].numpy(), ref[3].numpy(), rtol=1e-5)
