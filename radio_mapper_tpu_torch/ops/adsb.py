"""Mode-S / ADS-B (1090 MHz) detection and decoding, batched (rtl_adsb
parity).

Port of ``radio_mapper_tpu/ops/adsb.py``: one pass scores every sample
position as a preamble start, a non-maximum suppression over a preamble's
length and a static top-K pick the candidate frames, and all candidates
slice their 112 pulse-position bits at once; a Mode-S CRC-24 gates frames
on the host. Timing at 2.0 MS/s: preamble pulses at samples 0, 2, 7, 9 of
a 16-sample (8 µs) preamble; each data bit is 2 samples, first half high
= 1.

The reference's ``lax.top_k`` puts the lower index first among equal
scores, and every rejected position ties at −inf (those starts still feed
``bits``). ``torch.topk`` on CUDA does not fix the order of ties, so the
pick here is a stable descending sort cut to K: starts and bits equal the
reference's on every row.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

ADSB_RATE_HZ = 2_000_000.0
PREAMBLE_SAMPLES = 16
LONG_BITS = 112
SHORT_BITS = 56

# Sample offsets (within the preamble) that carry pulses vs. must be quiet.
_PULSE_OFFSETS = np.array([0, 2, 7, 9])
_QUIET_OFFSETS = np.array([4, 5, 6, 11, 12, 13, 14, 15])

_CRC24_POLY = 0xFFF409


class AdsbCandidates(NamedTuple):
    start_index: torch.Tensor  # [..., K] int32 sample index of preamble start
    score: torch.Tensor  # [..., K] preamble quality
    bits: torch.Tensor  # [..., K, 112] uint8 sliced bits
    valid: torch.Tensor  # [..., K] bool — passed score threshold


def preamble_score(mag: torch.Tensor) -> torch.Tensor:
    """Score each sample index as a potential preamble start:
    mean(pulse positions) − mean(quiet positions). The shifted reads are
    slices ``mag[..., o:o+usable]``."""
    usable = mag.shape[-1] - (PREAMBLE_SAMPLES + 2 * LONG_BITS)
    pulse = torch.stack([mag[..., o:o + usable] for o in _PULSE_OFFSETS], dim=-1)
    quiet = torch.stack([mag[..., o:o + usable] for o in _QUIET_OFFSETS], dim=-1)
    return pulse.mean(dim=-1) - quiet.mean(dim=-1)


def detect_frames(iq: torch.Tensor, *, max_frames: int = 8, min_score_snr: float = 3.0) -> AdsbCandidates:
    """Up to K Mode-S frames in blocks ``[..., N]`` of 2 MS/s complex
    baseband. ``min_score_snr``: the required preamble score relative to
    the block's mean magnitude."""
    mag = iq.abs() ** 2
    scores = preamble_score(mag)
    lead, usable = scores.shape[:-1], scores.shape[-1]

    # one hit per frame: a score must be the maximum of the 2·16+1 around
    # it (max_pool1d pads with −inf, as the reference's reduce_window)
    radius = PREAMBLE_SAMPLES
    pooled = torch.nn.functional.max_pool1d(
        scores.reshape(-1, 1, usable), kernel_size=2 * radius + 1, stride=1, padding=radius
    ).reshape(scores.shape)
    local_max = scores >= pooled
    floor = mag.mean(dim=-1, keepdim=True)
    candidate = local_max & (scores > min_score_snr * floor)
    masked = torch.where(candidate, scores, torch.full_like(scores, -torch.inf))
    ordered, order = torch.sort(masked, dim=-1, descending=True, stable=True)
    top_scores, starts = ordered[..., :max_frames], order[..., :max_frames]
    valid = torch.isfinite(top_scores)

    # bit k compares the two halves of its 2-sample PPM cell
    n = mag.shape[-1]
    bit_idx = PREAMBLE_SAMPLES + 2 * torch.arange(LONG_BITS, device=iq.device)
    pos_a = starts.unsqueeze(-1) + bit_idx  # [..., K, 112]
    k = starts.shape[-1]
    take = lambda pos: torch.gather(mag, -1, pos.clamp(0, n - 1).reshape(*lead, k * LONG_BITS)).reshape(
        *lead, k, LONG_BITS)
    bits = (take(pos_a) > take(pos_a + 1)).to(torch.uint8)
    return AdsbCandidates(
        start_index=torch.where(valid, starts, 0).to(torch.int32),
        score=torch.where(valid, top_scores, torch.zeros_like(top_scores)),
        bits=bits,
        valid=valid,
    )


def crc24(bits: np.ndarray) -> int:
    """Mode-S CRC-24 remainder (polynomial 0xFFF409, MSB-first): 0 for a
    valid frame whose trailing 24 bits are the parity."""
    msg = 0
    for b in bits:
        msg = (msg << 1) | int(b)
    nbits = len(bits)
    for i in range(nbits - 24):
        if msg & (1 << (nbits - 1 - i)):
            msg ^= _CRC24_POLY << (nbits - 24 - 1 - i)
    return msg & 0xFFFFFF


def frame_df(bits: np.ndarray) -> int:
    """Downlink format (first 5 bits)."""
    return int("".join(str(int(b)) for b in bits[:5]), 2)


def bits_to_hex(bits: np.ndarray) -> str:
    """Hex string in rtl_adsb's output convention (``*...;``)."""
    nbytes = len(bits) // 8
    out = []
    for k in range(nbytes):
        byte = 0
        for b in bits[8 * k: 8 * k + 8]:
            byte = (byte << 1) | int(b)
        out.append(f"{byte:02x}")
    return "*" + "".join(out) + ";"


def frames_hex(valid: np.ndarray, bits: np.ndarray, *, require_crc: bool = True) -> List[str]:
    """The hex frames of one block's candidates (host arrays ``valid [K]``,
    ``bits [K, 112]``): the downlink format picks 112 or 56 bits, the
    CRC-24 gates them unless ``require_crc`` is off."""
    out: List[str] = []
    for k in range(valid.shape[-1]):
        if not valid[k]:
            continue
        length = LONG_BITS if frame_df(bits[k]) >= 16 else SHORT_BITS
        frame_bits = bits[k, :length]
        if require_crc and crc24(frame_bits) != 0:
            continue
        out.append(bits_to_hex(frame_bits))
    return out


def decode_block(iq, *, max_frames: int = 8, require_crc: bool = True, device: torch.device | str = "cuda") -> List[str]:
    """Detect, slice, CRC-gate and hex-format the frames of one block
    ``[N]`` (numpy or a tensor) on ``device``; the candidates come to the
    host in one copy."""
    x = torch.as_tensor(np.asarray(iq, np.complex64)) if not isinstance(iq, torch.Tensor) else iq
    cands = detect_frames(x.to(device=device, dtype=torch.complex64), max_frames=max_frames)
    packed = torch.cat([cands.valid.to(torch.uint8).unsqueeze(-1), cands.bits], dim=-1).cpu().numpy()
    return frames_hex(packed[..., 0].astype(bool), packed[..., 1:], require_crc=require_crc)


# --- test-support encoder ----------------------------------------------------


def encode_frame_iq(
    payload_hex: str, *, amplitude: float = 1.0, noise: float = 0.01,
    pad_before: int = 100, pad_after: int = 100, seed: int = 0,
) -> np.ndarray:
    """Synthesize the 2 MS/s waveform of a Mode-S frame (for tests)."""
    rng = np.random.default_rng(seed)
    payload = bytes.fromhex(payload_hex)
    bits = []
    for byte in payload:
        for i in range(7, -1, -1):
            bits.append((byte >> i) & 1)
    samples = np.zeros(PREAMBLE_SAMPLES + 2 * len(bits), np.float64)
    for o in _PULSE_OFFSETS:
        samples[o] = 1.0  # 0.5 us pulse = one sample at 2 MS/s
    for k, b in enumerate(bits):
        cell = PREAMBLE_SAMPLES + 2 * k
        samples[cell + (0 if b else 1)] = 1.0
    mag = np.concatenate([np.zeros(pad_before), samples, np.zeros(pad_after)])
    field = np.sqrt(mag) * amplitude
    noise_iq = (rng.normal(size=field.size) + 1j * rng.normal(size=field.size)) * noise
    return (field + noise_iq).astype(np.complex64)


def append_crc(payload_hex_no_crc: str) -> str:
    """Compute and append the 24-bit Mode-S CRC to a hex payload."""
    payload = bytes.fromhex(payload_hex_no_crc)
    bits = []
    for byte in payload:
        for i in range(7, -1, -1):
            bits.append((byte >> i) & 1)
    bits_full = np.array(bits + [0] * 24, dtype=np.uint8)
    rem = crc24(bits_full)
    return payload_hex_no_crc + f"{rem:06x}"
