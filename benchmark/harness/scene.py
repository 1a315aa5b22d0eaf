"""The traffic generator: buoy networks and one emitter a channel-block,
synthesised on the device from the seed.

One general generator reads every traffic file (``traffic/<mix>.json``):

- ``blocks_per_dispatch`` D: a dispatch is ``[D, channels, B, 2·K·N]``
  uint8 (D = 0: ``[channels, B, 2·K·N]``); ``pool`` distinct dispatches
  are made at set-up and the window cycles through them;
- ``network``: B buoys at the sea surface, one a sector of a ring, at a
  seeded radius in ``buoy_radius_m`` and a seeded angle in its sector;
- ``emitter``: one a channel-block, at a seeded point within
  ``radius_m`` of the network's centre, at a seeded offset ±``offset_hz``
  from the channel's centre, seeded ``snr_db`` and carrier ``carrier_mhz``;
  ``signal`` is ``band_noise`` (Gaussian noise over ``bandwidth_hz``, as
  the repository's own scene generator makes it) or ``chirp`` (a linear
  sweep over ``bandwidth_hz`` across the capture);
- each buoy hears the emitter at its geometric delay (exact fractional
  delay), with free-space 1/d amplitude relative to the nearest buoy and
  the carrier's phase, plus complex white noise at ``snr_db`` below that
  buoy's signal; the block is scaled to ``quantize_rms_counts`` rms and
  rounded to the RTL-SDR's interleaved uint8 bytes.

Every draw comes from one ``torch.Generator`` on the device seeded from
``--seed``, in a fixed order, so a seed gives the same bytes and another
seed the same sizes with other values.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

SPEED_OF_LIGHT_M_S = 299_792_458.0
CHUNK_SAMPLES = 1 << 24  # complex samples a generation chunk holds


@dataclass
class Scene:
    pool: list  # uint8 tensors [*lead, B, 2·K·N]
    truth: list  # float64 emitter positions [*lead, 3], one a pool entry
    anchors: torch.Tensor  # [B, 3] float32 ENU metres
    lead: tuple  # the dispatch's leading dims
    samples_per_dispatch: int  # IQ samples a dispatch carries (all buoys)


def _uniform(g, n, lo_hi, device):
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device, dtype=torch.float64)


def buoy_layout(num_buoys: int, network: dict, g: torch.Generator, device) -> torch.Tensor:
    """``[B, 3]`` float64: buoy k in the k-th sector of a ring."""
    radius = _uniform(g, num_buoys, network["buoy_radius_m"], device)
    jitter = torch.rand(num_buoys, generator=g, device=device, dtype=torch.float64)
    ang = 2.0 * math.pi * (torch.arange(num_buoys, device=device, dtype=torch.float64) + jitter) / num_buoys
    return torch.stack([radius * torch.cos(ang), radius * torch.sin(ang), torch.zeros_like(ang)], dim=-1)


def _emitters(c, em, anchors, g, device):
    """Per channel-block draws: delays, amplitudes, carrier phases [c, B],
    offsets and SNRs [c]."""
    r = em["radius_m"] * torch.sqrt(torch.rand(c, generator=g, device=device, dtype=torch.float64))
    th = 2.0 * math.pi * torch.rand(c, generator=g, device=device, dtype=torch.float64)
    pos = torch.stack([r * torch.cos(th), r * torch.sin(th), torch.zeros_like(r)], dim=-1)
    dist = torch.linalg.vector_norm(pos.unsqueeze(1) - anchors.unsqueeze(0), dim=-1)  # [c, B]
    tau = dist / SPEED_OF_LIGHT_M_S
    amp = dist.amin(dim=1, keepdim=True) / dist.clamp(min=1.0)
    sign = torch.where(torch.rand(c, generator=g, device=device) < 0.5, -1.0, 1.0).to(torch.float64)
    offset = sign * _uniform(g, c, em["offset_hz"], device)
    snr_db = _uniform(g, c, em["snr_db"], device)
    fc = 1e6 * _uniform(g, c, em["carrier_mhz"], device)
    carrier = torch.remainder(fc.unsqueeze(1) * tau, 1.0)  # cycles of the carrier's delay
    return pos, tau, amp, carrier, offset, snr_db


def _band_noise(c, b, n, fs, em, tau, amp, carrier, offset, g, device):
    """Band-limited noise sources delayed per buoy: complex128 ``[c, B, n]``."""
    f = torch.fft.fftfreq(n, d=1.0 / fs, dtype=torch.float64).to(device)
    mask = ((f.unsqueeze(0) - offset.unsqueeze(1)).abs() <= em["bandwidth_hz"] / 2.0)
    spec = torch.complex(
        torch.randn(c, n, generator=g, device=device, dtype=torch.float64),
        torch.randn(c, n, generator=g, device=device, dtype=torch.float64),
    ) * mask
    power = (spec.abs() ** 2).sum(dim=-1, keepdim=True) / (n * n)  # mean |ifft(spec)|²
    spec = spec / torch.sqrt(power + 1e-300)
    cycles = torch.remainder(f.view(1, 1, n) * tau.unsqueeze(-1), 1.0) + carrier.unsqueeze(-1)
    ramp = torch.polar(amp.unsqueeze(-1).expand(-1, -1, n), -2.0 * math.pi * cycles)
    return torch.fft.ifft(spec.unsqueeze(1) * ramp, dim=-1)


def _chirp(c, b, n, fs, em, tau, amp, carrier, offset, g, device):
    """Linear sweeps over ``bandwidth_hz`` across the capture, delayed per
    buoy: complex128 ``[c, B, n]``."""
    t = torch.arange(n, device=device, dtype=torch.float64) / fs
    rate = em["bandwidth_hz"] / (n / fs)
    f0 = (offset - em["bandwidth_hz"] / 2.0).view(c, 1, 1)
    tb = t.view(1, 1, n) - tau.unsqueeze(-1)
    cycles = f0 * tb + 0.5 * rate * tb * tb - carrier.unsqueeze(-1)
    return torch.polar(amp.unsqueeze(-1).expand(-1, -1, n), 2.0 * math.pi * torch.remainder(cycles, 1.0))


SIGNALS = {"band_noise": _band_noise, "chirp": _chirp}


def _chunk(c, b, n, fs, traffic, anchors, g, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``c`` channel-blocks of uint8 IQ ``[c, B, 2n]`` and their emitters
    ``[c, 3]``."""
    em = traffic["emitter"]
    pos, tau, amp, carrier, offset, snr_db = _emitters(c, em, anchors, g, device)
    sig = SIGNALS[em["signal"]](c, b, n, fs, em, tau, amp, carrier, offset, g, device)
    noise_std = amp * torch.sqrt(0.5 / 10.0 ** (snr_db.unsqueeze(1) / 10.0))  # per part
    iq = sig + torch.complex(
        torch.randn(c, b, n, generator=g, device=device, dtype=torch.float64),
        torch.randn(c, b, n, generator=g, device=device, dtype=torch.float64),
    ) * noise_std.unsqueeze(-1)
    rms = torch.sqrt((iq.abs() ** 2).mean(dim=(1, 2), keepdim=True)) + 1e-30
    scaled = iq * (traffic["quantize_rms_counts"] / rms)
    inter = torch.stack([scaled.real, scaled.imag], dim=-1).reshape(c, b, 2 * n)
    return torch.clamp(torch.round(inter + 127.5), 0.0, 255.0).to(torch.uint8), pos


def synthesize(pipeline: dict, channels: int, traffic: dict, seed: int, device) -> Scene:
    """The cell's pool of dispatches and its buoy network, from ``seed``."""
    if traffic.get("generator") != "scene":
        raise ValueError(f"unknown generator {traffic.get('generator')!r}")
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    b = int(pipeline["num_buoys"])
    n = int(pipeline["block_len"]) * int(pipeline.get("correlation_dwells", 1))
    fs = float(pipeline["sample_rate_hz"])
    d = int(traffic["blocks_per_dispatch"])
    lead = (d, channels) if d else (channels,)
    blocks = int(np.prod(lead))
    anchors = buoy_layout(b, traffic["network"], g, device)
    chunk = max(1, CHUNK_SAMPLES // (b * n))
    pool, truth = [], []
    for _ in range(int(traffic["pool"])):
        raw = torch.empty((blocks, b, 2 * n), dtype=torch.uint8, device=device)
        pos = torch.empty((blocks, 3), dtype=torch.float64, device=device)
        for s in range(0, blocks, chunk):
            c = min(chunk, blocks - s)
            raw[s:s + c], pos[s:s + c] = _chunk(c, b, n, fs, traffic, anchors, g, device)
        pool.append(raw.reshape(*lead, b, 2 * n))
        truth.append(pos.reshape(*lead, 3))
    return Scene(pool, truth, anchors.to(torch.float32), lead, blocks * b * n)
