"""The streaming model: the port's ``channelize``, ``StreamingChannelizer``
and ``StreamingTDOA`` vs the JAX package's on the same numpy inputs.

- The streamed channelizer equals the port's one-shot ``channelize`` of
  the concatenated stream (after the same zero history) bit for bit, as
  ``tests/test_streaming_soak.py`` holds the reference's stream to its
  scan: every frame is the same sums of the same values.
- ``channelize`` against the reference's: the branch DFT is the port's
  matmul DFT and XLA's native FFT on the CPU, so within 1e-5 of the
  largest channel sample.
- ``StreamingTDOA.scan`` against JAX's ``scan`` from the same numpy
  state: on a stream where every subchannel carries the delayed source
  (the soak test's stream), lags within 1e-3 subchannel samples and the
  carried state bit for bit; on the simulated scene of
  ``tests/test_streaming_tdoa.py``, the emitter's subchannel (the one with
  the clear correlation peaks; noise-only subchannels have no stable
  argmax) within 1e-3 samples and its fix within 0.5 m.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radio_mapper_tpu.models import streaming as jstreaming
from radio_mapper_tpu.models import streaming_tdoa as jst
from radio_mapper_tpu.ops import channelizer as jpfb

from radio_mapper_tpu_torch import sim
from radio_mapper_tpu_torch.models import streaming, streaming_tdoa
from radio_mapper_tpu_torch.ops import channelizer
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()


def _noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


@pytest.mark.parametrize("m,taps,shift", [(8, 4, True), (16, 8, True), (5, 3, False)])
def test_channelize_matches_jax(m, taps, shift):
    x = _noise((2, 3, m * 200), seed=m)
    kw = dict(sample_rate_hz=2.4e6, taps_per_channel=taps, shift=shift)
    ours = channelizer.channelize(torch.from_numpy(x), m, **kw)
    ref = jpfb.channelize(jnp.asarray(x), m, **kw)
    assert ours.channels.dtype == torch.complex64 and ours.channels.shape == ref.channels.shape
    rch = np.asarray(ref.channels)
    assert np.abs(ours.channels.numpy() - rch).max() <= 1e-5 * np.abs(rch).max()
    np.testing.assert_array_equal(ours.channel_offset_hz, ref.channel_offset_hz)
    assert ours.channel_rate_hz == ref.channel_rate_hz
    with pytest.raises(ValueError):
        channelizer.channelize(torch.from_numpy(x[..., :-1]), m, **kw)


@pytest.mark.parametrize("m,taps,block", [(8, 4, 1024), (16, 8, 4096)])
def test_streamed_channelizer_equals_one_shot(m, taps, block):
    blocks = 5
    stream = _noise((3, blocks * block), seed=block)
    ch = streaming.StreamingChannelizer(m, sample_rate_hz=2.048e6, taps_per_channel=taps, device="cpu")
    state = ch.init_state((3,))
    parts = []
    for k in range(blocks):
        state, out = ch.step(state, torch.from_numpy(stream[:, k * block:(k + 1) * block]))
        assert out.channels.shape == (3, m, block // m)
        parts.append(out.channels)
    streamed = torch.cat(parts, dim=-1)
    full = torch.cat([torch.zeros(3, ch.history, dtype=torch.complex64), torch.from_numpy(stream)], dim=-1)
    one_shot = channelizer.channelize(full, m, sample_rate_hz=2.048e6, taps_per_channel=taps).channels
    torch.testing.assert_close(streamed, one_shot, rtol=0, atol=0)
    torch.testing.assert_close(state.tail, torch.from_numpy(stream[:, -ch.history:]), rtol=0, atol=0)
    # the reference's streamed channelizer on the same blocks
    jch = jstreaming.StreamingChannelizer(m, sample_rate_hz=2.048e6, taps_per_channel=taps)
    jstate = jch.init_state((3,))
    jparts = []
    for k in range(blocks):
        jstate, jout = jch.step(jstate, jnp.asarray(stream[:, k * block:(k + 1) * block]))
        jparts.append(np.asarray(jout.channels))
    ref = np.concatenate(jparts, axis=-1)
    assert np.abs(streamed.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    with pytest.raises(ValueError):
        ch.step(state, torch.zeros(3, block + 1, dtype=torch.complex64))


SOAK_CFG = dict(num_buoys=4, num_subchannels=8, taps_per_channel=4, sample_rate_hz=2_048_000.0,
                block_len=1024, max_lag=16, solver_iterations=8)
DELAYS = [0, 16, 32, 48]  # wide samples; buoy b hears s(t − D_b)


def _delayed_stream(num_blocks, seed=0):
    """``tests/test_streaming_soak.py``'s stream: one long noise waveform at
    integer delays plus noise, cut into ``[T, B, L]`` blocks."""
    rng = np.random.default_rng(seed)
    n, pad = num_blocks * SOAK_CFG["block_len"], max(DELAYS)
    s = (rng.normal(size=n + pad) + 1j * rng.normal(size=n + pad)).astype(np.complex64)
    rx = np.stack([s[pad - d: pad - d + n] for d in DELAYS])
    rx += 0.05 * (rng.normal(size=rx.shape) + 1j * rng.normal(size=rx.shape)).astype(np.complex64)
    return rx.reshape(4, num_blocks, SOAK_CFG["block_len"]).transpose(1, 0, 2).copy()


def test_streaming_scan_matches_jax_from_same_state():
    blocks = _delayed_stream(3)
    rng = np.random.default_rng(1)
    anchors = rng.normal(scale=5_000.0, size=(4, 3)).astype(np.float32)
    anchors[:, 2] = 0.0
    tail = _noise((4, 3 * 8), seed=2)  # a warm state: (T − 1)·M samples of history
    jmodel = jst.StreamingTDOA(jst.StreamingTDOAConfig(**SOAK_CFG))
    jstate, jout = jmodel.jit_scan()(jnp.asarray(blocks), jnp.asarray(anchors),
                                     jstreaming.ChannelizerState(tail=jnp.asarray(tail)))
    model = streaming_tdoa.StreamingTDOA(streaming_tdoa.StreamingTDOAConfig(**SOAK_CFG), device="cpu")
    state, out = model.scan(torch.from_numpy(blocks), torch.from_numpy(anchors),
                            streaming.ChannelizerState(tail=torch.from_numpy(tail)))
    assert out._fields == jout._fields
    for f in out._fields:
        assert tuple(getattr(out, f).shape) == np.asarray(getattr(jout, f)).shape, f
    np.testing.assert_array_equal(state.tail.numpy(), np.asarray(jstate.tail))
    np.testing.assert_allclose(out.lags.numpy(), np.asarray(jout.lags), atol=1e-3)
    np.testing.assert_allclose(out.psr.numpy(), np.asarray(jout.psr), rtol=1e-3)
    np.testing.assert_allclose(out.weights.numpy(), np.asarray(jout.weights), atol=1e-3)
    truth = (np.asarray(DELAYS)[model.pair_i.numpy()] - np.asarray(DELAYS)[model.pair_j.numpy()]) / 8
    assert np.abs(out.lags.numpy()[1:] - truth).max() < 0.35  # the first block holds the warm state's seam
    # scan is the step loop
    st = streaming.ChannelizerState(tail=torch.from_numpy(tail))
    for k in range(3):
        st, one = model.step(st, torch.from_numpy(blocks[k]), torch.from_numpy(anchors))
        for a, b in zip(out, one):
            torch.testing.assert_close(a[k], b, rtol=0, atol=0)


def test_streaming_scene_matches_jax():
    """``tests/test_streaming_tdoa.py``'s scene: 4 OKC buoys, a 110 kHz
    noise emitter at 25 dB, 8 subchannels × 6 taps, two 16384-sample blocks."""
    scen = sim.default_scenario(signal="noise", bandwidth_hz=110e3, snr_db=25.0, seed=6, block_len=32_768)
    cap = sim.synthesize(scen)
    kw = dict(num_buoys=4, num_subchannels=8, taps_per_channel=6, sample_rate_hz=scen.sample_rate_hz,
              block_len=16_384, max_lag=8, solver_iterations=25)
    blocks = cap.iq.astype(np.complex64).reshape(4, 2, 16_384).transpose(1, 0, 2).copy()
    anchors = cap.buoy_enu.astype(np.float32)
    _, jout = jst.StreamingTDOA(jst.StreamingTDOAConfig(**kw)).jit_scan()(jnp.asarray(blocks), jnp.asarray(anchors))
    model = streaming_tdoa.StreamingTDOA(streaming_tdoa.StreamingTDOAConfig(**kw), device="cpu")
    _, out = model.scan(torch.from_numpy(blocks), torch.from_numpy(anchors))
    best = int(np.argmax(out.weights[1].numpy().sum(-1)))
    assert best == int(np.argmax(np.asarray(jout.weights)[1].sum(-1))) == 4  # the centre subchannel
    np.testing.assert_allclose(out.lags[:, best].numpy(), np.asarray(jout.lags)[:, best], atol=1e-3)
    np.testing.assert_allclose(out.fixes_enu[:, best].numpy(), np.asarray(jout.fixes_enu)[:, best], atol=0.5)
    err = np.linalg.norm(out.fixes_enu[1, best, :2].numpy() - cap.emitter_enu[0][:2])
    assert err < 600.0, err


def test_example_inputs_match_jax():
    cfg = dict(num_buoys=3, num_subchannels=4, taps_per_channel=4, block_len=256, max_lag=8, solver_iterations=3)
    jb, ja = jst.StreamingTDOA(jst.StreamingTDOAConfig(**cfg)).example_inputs(num_blocks=2, seed=3)
    model = streaming_tdoa.StreamingTDOA(streaming_tdoa.StreamingTDOAConfig(**cfg), device="cpu")
    b, a = model.example_inputs(num_blocks=2, seed=3)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert model.init_state().tail.shape == (3, 12)
    assert streaming_tdoa.StreamingTDOAConfig() == streaming_tdoa.StreamingTDOAConfig(
        **{f: getattr(jst.StreamingTDOAConfig(), f) for f in jst.StreamingTDOAConfig.__dataclass_fields__}
    )
    with pytest.raises(ValueError):
        streaming_tdoa.StreamingTDOA(streaming_tdoa.StreamingTDOAConfig(block_len=1000), device="cpu")
