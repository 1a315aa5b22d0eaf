"""Mode-S / ADS-B: the port's ``ops/adsb`` vs the JAX package's on the same
numpy blocks.

``detect_frames`` on a batch ``[4, 4096]`` of encoder frames (long and
short, one with a corrupted CRC, two in one block) plus noise, and on
noise-only blocks: starts, valid flags and bits equal on every row (the
port's stable descending sort keeps ``lax.top_k``'s order of ties, the
−inf ties of rejected positions included), scores within 1e-5 relative
to the row's largest |score| (float32 means of the same magnitudes).
``decode_block`` gives the same hex list, with the CRC gate on and off;
the CRC, hex and encoder helpers give equal outputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radio_mapper_tpu.ops import adsb as jadsb

from radio_mapper_tpu_torch.ops import adsb
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()

LONG = "8d4840d6202cc371c32ce0"  # DF17 (88 bits), without its CRC
SHORT = "5d4840d6"  # DF11 all-call reply, without its CRC
BLOCK = 4096


def _corrupt(hexframe):
    b = bytearray(bytes.fromhex(hexframe))
    b[5] ^= 0x10
    return b.hex()


def _block(frames, seed, noise=0.05):
    """One ``[BLOCK]`` complex64 block: each ``(hex, start)`` frame's
    waveform placed at ``start``, on complex noise."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=BLOCK) + 1j * rng.normal(size=BLOCK)) * noise
    for k, (hexframe, start) in enumerate(frames):
        w = adsb.encode_frame_iq(hexframe, noise=0.0, pad_before=0, pad_after=0, seed=k)
        x[start:start + w.size] += w
    return x.astype(np.complex64)


@pytest.fixture(scope="module")
def batch():
    long_ok, short_ok = adsb.append_crc(LONG), adsb.append_crc(SHORT)
    return np.stack([
        _block([(long_ok, 300)], 1),
        _block([(short_ok, 120), (long_ok, 2000)], 2),
        _block([(_corrupt(long_ok), 700)], 3),
        _block([], 4),
    ])


def _detect_both(x, **kw):
    ours = adsb.detect_frames(torch.from_numpy(x), **kw)
    ref = jadsb.detect_frames(jnp.asarray(x), **kw)
    return ours, ref


def _hold(ours, ref):
    np.testing.assert_array_equal(ours.start_index.numpy(), np.asarray(ref.start_index))
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(ours.bits.numpy(), np.asarray(ref.bits))
    rs = np.asarray(ref.score)
    scale = np.maximum(np.abs(rs).max(-1, keepdims=True), 1e-30)
    assert (np.abs(ours.score.numpy() - rs) / scale).max() <= 1e-5
    assert ours.start_index.dtype == torch.int32 and ours.bits.dtype == torch.uint8


@pytest.mark.parametrize("max_frames", [8, 3])
def test_detect_frames_batched(batch, max_frames):
    ours, ref = _detect_both(batch, max_frames=max_frames)
    _hold(ours, ref)
    valid = ours.valid.numpy()
    assert valid[0].sum() >= 1 and valid[1].sum() >= 2 and valid[2].sum() >= 1


def test_detect_frames_noise_only():
    x = np.stack([_block([], s, noise=1.0) for s in (10, 11)])
    ours, ref = _detect_both(x)
    _hold(ours, ref)  # rejected candidates' starts and bits too


def test_detect_frames_threshold_variants(batch):
    ours, ref = _detect_both(batch[:2], max_frames=16, min_score_snr=1.5)
    _hold(ours, ref)


def _decode_both(x, **kw):
    return adsb.decode_block(x, device="cpu", **kw), jadsb.decode_block(x, **kw)


def test_decode_block_hex(batch):
    long_ok, short_ok = adsb.append_crc(LONG), adsb.append_crc(SHORT)
    for row in range(batch.shape[0]):
        for require_crc in (True, False):
            ours, ref = _decode_both(batch[row], require_crc=require_crc)
            assert ours == ref
    assert adsb.decode_block(batch[0], device="cpu") == [f"*{long_ok};"]
    assert sorted(adsb.decode_block(batch[1], device="cpu")) == sorted([f"*{long_ok};", f"*{short_ok};"])
    bad = f"*{_corrupt(long_ok)};"
    assert adsb.decode_block(batch[2], device="cpu") == []  # the CRC gate drops it
    assert bad in adsb.decode_block(batch[2], device="cpu", require_crc=False)


def test_decode_block_cli_selftest_frame():
    """The CLI's ``adsb --source selftest`` block."""
    payload = "8d4840d6202cc371c32ce057"
    iq = jadsb.encode_frame_iq(jadsb.append_crc(payload), noise=0.02)
    np.testing.assert_array_equal(adsb.encode_frame_iq(adsb.append_crc(payload), noise=0.02), iq)
    ours, ref = _decode_both(iq)
    assert ours == ref == [f"*{adsb.append_crc(LONG)};"] == ["*8d4840d6202cc371c32ce0576098;"]
    # a tensor input decodes the same
    assert adsb.decode_block(torch.from_numpy(iq), device="cpu") == ref


@pytest.mark.parametrize("payload", [LONG, SHORT, "8d406b902015a678d4d220", "a0001838ca3e51f0a8000047"])
def test_crc_hex_and_encoder_helpers(payload):
    assert adsb.append_crc(payload) == jadsb.append_crc(payload)
    full = adsb.append_crc(payload)
    bits = np.array([(b >> i) & 1 for b in bytes.fromhex(full) for i in range(7, -1, -1)], np.uint8)
    assert adsb.crc24(bits) == jadsb.crc24(bits) == 0
    flipped = bits.copy()
    flipped[9] ^= 1
    assert adsb.crc24(flipped) == jadsb.crc24(flipped) != 0
    assert adsb.frame_df(bits) == jadsb.frame_df(bits)
    assert adsb.bits_to_hex(bits) == jadsb.bits_to_hex(bits) == f"*{full};"
    kw = dict(amplitude=0.7, noise=0.03, pad_before=17, pad_after=5, seed=9)
    np.testing.assert_array_equal(adsb.encode_frame_iq(full, **kw), jadsb.encode_frame_iq(full, **kw))


def test_constants():
    for name in ("ADSB_RATE_HZ", "PREAMBLE_SAMPLES", "LONG_BITS", "SHORT_BITS"):
        assert getattr(adsb, name) == getattr(jadsb, name)
    x = np.abs(_block([], 5)) ** 2
    np.testing.assert_allclose(adsb.preamble_score(torch.from_numpy(x.astype(np.float32))).numpy(),
                               np.asarray(jadsb.preamble_score(jnp.asarray(x, jnp.float32))), rtol=0, atol=1e-6)
