"""The ingest layer: the port's ``ops/iq`` codec, sources, native ring and
``IngestLoop`` vs the JAX package's, on the CPU.

- ``ops/iq``, ``SimulatedSource``, ``FileSource``: bit for bit (the same
  numpy code; the torch encoder rounds half to even as ``jnp.round``).
- ``NativeIngest``: the port builds its own copy of ``native/ingest.cpp``
  (``radio_mapper_tpu_torch/_build``); its bytes equal the reference
  library's bit for bit. The ring drops an incoming chunk that does not
  fit, so the first ``ring_bytes`` read from an unpaced synthetic ring are
  the seed's stream, whatever the timing.
- ``IngestLoop`` on ``device="cpu"`` against the reference's loop on the
  same unpaced seed (a ring larger than every byte the run reads): the last
  output within the tolerances of ``tests/test_torch_pipeline.py``, the
  JAX step on the TPU routing (``_jax_fused_run``); equal ``steps``,
  ``samples_per_step`` and ``bytes_consumed``.
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radio_mapper_tpu import sim as jsim
from radio_mapper_tpu.ingest import native as jnative
from radio_mapper_tpu.ingest import runner as jrunner
from radio_mapper_tpu.ingest import sources as jsources
from radio_mapper_tpu.models import pipeline as jpipe
from radio_mapper_tpu.ops import iq as jiq

from radio_mapper_tpu_torch import device, sim
from radio_mapper_tpu_torch.ingest import native, runner, sources
from radio_mapper_tpu_torch.models import pipeline
from radio_mapper_tpu_torch.ops import iq
from radio_mapper_tpu_torch.testing import cap_cpu_threads

from test_torch_pipeline import _assert_outputs_match, _jax_fused_run, _quantize

cap_cpu_threads()

CH, BUOYS, BLOCK = 2, 4, 4096
BLOCK_BYTES = CH * BUOYS * 2 * BLOCK


def _complex(seed, shape, scale=40.0):
    rng = np.random.default_rng(seed)
    return (scale * (rng.normal(size=shape) + 1j * rng.normal(size=shape))).astype(np.complex64)


# -- ops/iq -------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1.0, iq.UINT8_SCALE])
def test_iq_codec_matches_jax(scale):
    x = _complex(0, (3, 1000), scale=60.0 * scale)
    x[0, :4] = [200 * scale, -200 * scale, 0.5 * scale, 1.5 * scale]  # saturation and ties
    ours = iq.encode_uint8_iq(torch.from_numpy(x), scale=scale).numpy()
    ref = np.asarray(jiq.encode_uint8_iq(jnp.asarray(x), scale=scale))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(iq.encode_uint8_iq_numpy(x, scale=scale), jiq.encode_uint8_iq_numpy(x, scale=scale))
    np.testing.assert_array_equal(iq.decode_uint8_iq_numpy(ours, scale=scale),
                                  jiq.decode_uint8_iq_numpy(ref, scale=scale))
    assert iq.UINT8_SCALE == jiq.UINT8_SCALE
    # the torch decode inverts the encode within half a count
    back = iq.decode_uint8_iq(torch.from_numpy(ours), scale=scale).numpy()
    inside = np.abs(x.real) < 120 * scale
    assert np.abs(back.real - x.real)[inside].max() <= 0.5 * scale + 1e-6


def test_iq_bin_files_match_jax(tmp_path):
    x = _complex(1, 5001)
    ours, ref = tmp_path / "ours.bin", tmp_path / "ref.bin"
    iq.save_iq_bin(str(ours), x)
    jiq.save_iq_bin(str(ref), x)
    assert ours.read_bytes() == ref.read_bytes()
    with open(ours, "ab") as f:  # an odd trailing byte is dropped on load
        f.write(b"\x07")
    np.testing.assert_array_equal(iq.load_iq_bin(str(ours), scale=0.5), jiq.load_iq_bin(str(ours), scale=0.5))


# -- sources ------------------------------------------------------------------


def _scenarios(**kw):
    spec = dict(signal="bpsk", bandwidth_hz=50e3, snr_db=15.0, seed=4, block_len=4096)
    spec.update(kw)
    return sim.default_scenario(**spec), jsim.default_scenario(**spec)


@pytest.mark.parametrize("tune_offset_hz", [0.0, 25e3, 5e6])
def test_simulated_source_reads_match_jax(tune_offset_hz):
    """On channel, tuned off the centre (the baseband mix) and off channel
    (the noise cache): reads of uneven sizes across the cache's wrap."""
    scen, jscen = _scenarios()
    ours = sources.SimulatedSource(scen, 2, block_cache=8192)
    ref = jsources.SimulatedSource(jscen, 2, block_cache=8192)
    for src in (ours, ref):
        src.tune(scen.center_frequency_mhz * 1e6 + tune_offset_hz)
    for n in (1000, 5000, 8192, 3):
        a, b = ours.read(n), ref.read(n)
        assert a.dtype == b.dtype == np.complex64
        np.testing.assert_array_equal(a, b)
    assert ours.power_offset_db == ref.power_offset_db
    assert ours.true_delay_s(0) == ref.true_delay_s(0)
    assert ours.window_anchor_ns() == ref.window_anchor_ns() == 0


def test_simulated_source_pps_aligned_windows():
    """With PPS alignment two buoys of the scenario read the same absolute
    window: the same samples as the reference's sources at that moment."""
    scen, jscen = _scenarios(signal="noise", bandwidth_hz=150e3)
    period = 1000.0  # one window through the whole test
    ours = [sources.SimulatedSource(scen, k, pps_align_s=period) for k in range(2)]
    ref = [jsources.SimulatedSource(jscen, k, pps_align_s=period) for k in range(2)]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.read(2048), b.read(2048))
        assert a.window_anchor_ns() == b.window_anchor_ns() > 0


@pytest.mark.parametrize("loop", [True, False])
def test_file_source_reads_match_jax(tmp_path, loop):
    path = str(tmp_path / "cap.bin")
    jiq.save_iq_bin(path, _complex(2, 3000))
    ours = sources.FileSource(path, sample_rate_hz=2.4e6, loop=loop)
    ref = jsources.FileSource(path, sample_rate_hz=2.4e6, loop=loop)
    for n in (1000, 2500, 4000):
        np.testing.assert_array_equal(ours.read(n), ref.read(n))
    (tmp_path / "empty.bin").write_bytes(b"")
    with pytest.raises(ValueError):
        sources.FileSource(str(tmp_path / "empty.bin"), sample_rate_hz=2.4e6)


def test_rtl_sdr_process_source_reads_a_pipe(tmp_path):
    """The ``rtl_sdr`` pipe reader on a stand-in binary that writes a known
    capture to stdout: decoded as the reference decodes it."""
    raw = np.random.default_rng(3).integers(0, 256, 8192, dtype=np.uint8)
    cap = tmp_path / "raw.bin"
    raw.tofile(cap)
    fake = tmp_path / "rtl_sdr"
    fake.write_text(f"#!/bin/sh\ncat {cap}\nexec sleep 60\n")  # stays alive, as rtl_sdr does
    fake.chmod(0o755)
    src = sources.RtlSdrProcessSource(binary=str(fake))
    try:
        np.testing.assert_array_equal(src.read(1024), jiq.decode_uint8_iq_numpy(raw[:2048]).astype(np.complex64))
        np.testing.assert_array_equal(src.read(1024), jiq.decode_uint8_iq_numpy(raw[2048:4096]).astype(np.complex64))
        src.tune(100e6)  # restarts the process
        assert src.center_frequency_hz == 100e6 and src._proc is None
    finally:
        src.close()


# -- native ring ----------------------------------------------------------------


def test_native_synthetic_bytes_match_jax():
    ours = native.NativeIngest.open_synthetic(7, ring_bytes=1 << 20)
    ref = jnative.NativeIngest.open_synthetic(7, ring_bytes=1 << 20)
    try:
        a, ts = ours.read_bytes(1 << 19, timeout_ms=30_000)
        b, _ = ref.read_bytes(1 << 19, timeout_ms=30_000)
        assert a.size == b.size == 1 << 19 and ts > 0
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ours.decode(a, 0.5), ref.decode(b, 0.5))
        st = ours.stats()
        assert st["bytes_consumed"] == 1 << 19 and st["error"] == 0
    finally:
        ours.close()
        ref.close()
    assert native.library_path().parent == native.BUILD_DIR
    assert native.library_path().exists()


def test_native_file_bytes_match_jax(tmp_path):
    data = np.random.default_rng(5).integers(0, 256, 100_000, dtype=np.uint8)
    p = tmp_path / "raw.bin"
    data.tofile(p)
    ours = native.NativeIngest.open_file(str(p), loop=True)
    ref = jnative.NativeIngest.open_file(str(p), loop=True)
    try:
        a = np.empty(250_000, np.uint8)  # past EOF: the file loops
        got, _ = ours.read_into(a, 30_000)
        b, _ = ref.read_bytes(250_000, timeout_ms=30_000)
        assert got == b.size == 250_000
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a[:100_000], data)
    finally:
        ours.close()
        ref.close()


def test_native_ring_source_and_parallel_drain(tmp_path):
    raw = np.random.default_rng(0).integers(0, 256, 1 << 18, dtype=np.uint8)
    p = tmp_path / "iq.bin"
    raw.tofile(p)
    src = native.NativeRingSource(native.NativeIngest.open_file(str(p)), sample_rate_hz=2_048_000.0)
    ref = jnative.NativeRingSource(jnative.NativeIngest.open_file(str(p)), sample_rate_hz=2_048_000.0)
    try:
        a, b = src.read(8192), ref.read(8192)
        assert a.dtype == np.complex64 and src.last_block_ts_ns > 0
        np.testing.assert_array_equal(a, b)
    finally:
        src.close()
        ref.close()
    ing = native.NativeIngest.open_synthetic(9, ring_bytes=1 << 24)
    ref = jnative.NativeIngest.open_synthetic(9, ring_bytes=1 << 24)
    try:
        a = np.empty(5 << 20, np.uint8)  # above the parallel drain's 4 MB threshold
        b = np.empty(5 << 20, np.uint8)
        assert ing.read_into(a, 30_000, threads=4)[0] == ref.read_into(b, 30_000, threads=4)[0] == a.size
        np.testing.assert_array_equal(a, b)
        with pytest.raises(ValueError):
            ing.read_into(np.empty(8, np.float32))
    finally:
        ing.close()
        ref.close()


def test_native_unavailable_without_a_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(native.NativeUnavailable):
        native._build(tmp_path / "libringest_x.so")
    assert not (tmp_path / "libringest_x.so").exists()


def test_drop_accounting_fires_when_consumer_stalls():
    """An unpaced producer into a small ring with a stalled consumer drops
    bytes, and the loop reports the ring's count unchanged."""
    ing = native.NativeIngest.open_synthetic(4, ring_bytes=1 << 17)
    try:
        time.sleep(0.2)  # the producer free-runs; nothing is read
        assert ing.stats()["bytes_dropped"] > 0
        cfg = pipeline.PipelineConfig(num_buoys=2, block_len=1024, max_lag=32, solver_iterations=3)
        pipe = pipeline.TDOAPipeline(cfg, device="cpu")
        loop = runner.IngestLoop.from_pipeline(pipe, ing, channels=1, anchors=torch.zeros(1, 2, 3))
        stats = loop.run(2, warmup_steps=0)
        after = ing.stats()
        assert stats.dropped_bytes > 0 and stats.dropped_bytes <= after["bytes_dropped"]
        assert stats.drops == stats.dropped_bytes and stats.dropped_samples == stats.dropped_bytes // 2
        assert stats.bytes_consumed == 2 * 1 * 2 * 2 * 1024
    finally:
        ing.close()


def test_underrun_raises():
    """A source that cannot fill a block in time is an explicit error."""
    cfg = pipeline.PipelineConfig(num_buoys=2, block_len=4096, max_lag=64, solver_iterations=3)
    pipe = pipeline.TDOAPipeline(cfg, device="cpu")
    ing = native.NativeIngest.open_synthetic_paced(1, bytes_per_s=1000.0, ring_bytes=1 << 20)
    loop = runner.IngestLoop.from_pipeline(pipe, ing, channels=1, anchors=torch.zeros(1, 2, 3))
    try:
        with pytest.raises(IOError):
            loop._read_block(timeout_ms=200)
    finally:
        ing.close()


# -- IngestLoop -----------------------------------------------------------------


def _config():
    return dict(num_buoys=BUOYS, block_len=BLOCK, sample_rate_hz=2_048_000.0, max_lag=128, solver_iterations=10)


def _anchors():
    a = np.random.default_rng(0).normal(scale=5_000.0, size=(BUOYS, 3)).astype(np.float32)
    a[:, 2] = 0.0
    return np.ascontiguousarray(np.broadcast_to(a, (CH, BUOYS, 3)))


def _port_loop(ingest, **kw):
    pipe = pipeline.TDOAPipeline(pipeline.PipelineConfig(**_config()), device="cpu")
    return pipe, runner.IngestLoop.from_pipeline(pipe, ingest, channels=CH, anchors=torch.from_numpy(_anchors()), **kw)


class _Recorder:
    """Wraps a ring and keeps a copy of every block the loop drained."""

    def __init__(self, ingest, with_read_into=True):
        self.ingest, self.blocks = ingest, []
        if with_read_into:
            self.read_into = self._read_into

    def _read_into(self, out, timeout_ms=2000, *, threads=0):
        got, ts = self.ingest.read_into(out, timeout_ms, threads=threads)
        self.blocks.append(out[:got].copy())
        return got, ts

    def read_bytes(self, nbytes, timeout_ms=2000):
        raw, ts = self.ingest.read_bytes(nbytes, timeout_ms)
        self.blocks.append(raw.copy())
        return raw, ts

    def stats(self):
        return self.ingest.stats()


def _scene_file(tmp_path):
    """One block of a simulated scene, quantized as the dongle would, in a
    capture file: ``(path, anchors [CH, B, 3], emitter)``."""
    cap = sim.synthesize(sim.default_scenario(signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=8,
                                              block_len=BLOCK))
    raw = np.broadcast_to(_quantize(cap.iq), (CH, BUOYS, 2 * BLOCK))
    path = tmp_path / "scene.bin"
    np.ascontiguousarray(raw).tofile(path)
    anchors = np.ascontiguousarray(np.broadcast_to(cap.buoy_enu.astype(np.float32), (CH, BUOYS, 3)))
    return str(path), anchors, cap.emitter_enu[0]


def _tap(loop):
    """Keep every output of ``loop``'s step."""
    outs, step = [], loop.step
    loop.step = lambda raw, anchors: outs.append(step(raw, anchors)) or outs[-1]
    return outs


@pytest.mark.parametrize("ring", ["synthetic", "file"])
def test_ingest_loop_matches_jax_loop(ring, tmp_path):
    """Both loops on the same ring: the unpaced synthetic seed (noise) and
    a looping capture file of a scene. Every byte of the run (5 blocks of
    64 KiB) fits the ring, so both read the same bytes. On the synthetic
    noise the LM fix is not compared: it solves noise, whose valley is
    flat (0.56 m apart here, as quiet subchannels are in the wideband
    tests); lags, detections and weights are."""
    seed, steps, ring_bytes = 11, 4, 1 << 21
    anchors = _anchors()
    if ring == "synthetic":
        open_ring = lambda mod: mod.NativeIngest.open_synthetic(seed, ring_bytes=ring_bytes)
        cfg = _config()
    else:
        path, anchors, emitter = _scene_file(tmp_path)
        open_ring = lambda mod: mod.NativeIngest.open_file(path, ring_bytes=ring_bytes)
        cfg = dict(_config(), power_offset_db=0.0)
    ing = open_ring(native)
    try:
        pipe = pipeline.TDOAPipeline(pipeline.PipelineConfig(**cfg), device="cpu")
        loop = runner.IngestLoop.from_pipeline(pipe, ing, channels=CH, anchors=torch.from_numpy(anchors))
        outs = _tap(loop)
        stats = loop.run(steps, warmup_steps=1)
    finally:
        ing.close()

    def jax_loop():
        jing = open_ring(jnative)
        try:
            jloop = jrunner.IngestLoop(
                jpipe.TDOAPipeline(jpipe.PipelineConfig(**cfg)).jit_step_split_uint8(), jing, channels=CH,
                num_buoys=BUOYS, block_len=BLOCK, anchors=jax.device_put(anchors),
            )
            jouts = _tap(jloop)
            return jloop.run(steps, warmup_steps=1), jouts[-1]
        finally:
            jing.close()

    jstats, ref = _jax_fused_run(jax_loop)
    assert (stats.steps, stats.samples_per_step, stats.bytes_consumed) == (
        jstats.steps, jstats.samples_per_step, jstats.bytes_consumed) == (steps, CH * BUOYS * BLOCK,
                                                                         (steps + 1) * BLOCK_BYTES)
    assert stats.real_time_ratio == 0.0 and stats.sustained_samples_per_s > 0
    ours = outs[-1]
    if ring == "file":
        _assert_outputs_match(ours, ref)
        err = np.linalg.norm(ours.fix.position_enu.numpy()[..., :2] - emitter[:2], axis=-1)
        assert (err < 50.0).all(), err
    else:
        np.testing.assert_allclose(ours.correlation.lag_samples.numpy(), np.asarray(ref.correlation.lag_samples),
                                   atol=1e-3)
        np.testing.assert_array_equal(ours.peaks.valid.numpy(), np.asarray(ref.peaks.valid))
        np.testing.assert_array_equal(ours.peaks.bin_index.numpy(), np.asarray(ref.peaks.bin_index))
        np.testing.assert_allclose(ours.peaks.noise_floor_db.numpy(), np.asarray(ref.peaks.noise_floor_db),
                                   atol=1e-3)
        np.testing.assert_allclose(ours.pair_weights.numpy(), np.asarray(ref.pair_weights), atol=1e-3)


def test_read_bytes_path_and_slots_equal_the_direct_step():
    """The pure-Python ``read_bytes`` path and ``read_into``, through the
    two-slot rotation on the CPU, feed the step the ring's bytes: outputs
    equal to the step called directly on the recorded blocks, bit for
    bit."""
    for with_read_into in (False, True):
        rec = _Recorder(native.NativeIngest.open_synthetic(12, ring_bytes=1 << 21), with_read_into)
        try:
            pipe, loop = _port_loop(rec)
            outs = _tap(loop)
            loop.run(3, warmup_steps=0)
        finally:
            rec.ingest.close()
        assert len(rec.blocks) == 3
        anchors = torch.from_numpy(_anchors())
        for blk, out in zip(rec.blocks, outs):
            direct = pipe.step_split_uint8(torch.from_numpy(blk.reshape(CH, BUOYS, 2 * BLOCK)), anchors)
            for a, b in zip(_leaves(out), _leaves(direct)):
                torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _leaves(x):
    return [x] if isinstance(x, torch.Tensor) else [t for f in x for t in _leaves(f)]


def test_blocks_per_dispatch_runs_the_scan_step():
    rec = _Recorder(native.NativeIngest.open_synthetic(13, ring_bytes=1 << 21))
    try:
        pipe, loop = _port_loop(rec, blocks_per_dispatch=2)
        assert loop.step == pipe.step_split_uint8_scan and loop.block_bytes == 2 * BLOCK_BYTES
        outs = _tap(loop)
        stats = loop.run(2, warmup_steps=0)
    finally:
        rec.ingest.close()
    assert stats.samples_per_step == 2 * CH * BUOYS * BLOCK and stats.bytes_consumed == 4 * BLOCK_BYTES
    anchors = torch.from_numpy(_anchors())
    for blk, out in zip(rec.blocks, outs):
        pair = blk.reshape(2, CH, BUOYS, 2 * BLOCK)
        assert out.fix.position_enu.shape == (2, CH, 3)
        for t in range(2):
            one = pipe.step_split_uint8(torch.from_numpy(pair[t]), anchors)
            for a, b in zip(_leaves(out), _leaves(one)):
                torch.testing.assert_close(a[t], b, rtol=0, atol=0, equal_nan=True)


class _StubEvent:
    """A copy's end event on the CPU: pending until ``synchronize``."""

    def __init__(self, log, slot):
        self.log, self.slot, self.done = log, slot, False

    def synchronize(self):
        self.log.append(("sync", self.slot))
        self.done = True


def test_slot_ring_waits_for_the_pending_copy():
    """A slot is handed out to be drained again only after the event of the
    copy that last read it has been synchronized."""
    log = []
    slots = runner.SlotRing(64, pin=False)
    events = {}
    for step in range(6):
        k, view = slots.acquire()
        assert k == step % 2 and view.size == 64 and view.dtype == np.uint8
        prev = events.get(k)
        assert prev is None or prev.done, f"slot {k} drained while its copy is pending"
        log.append(("drain", k))
        view[:] = step
        events[k] = _StubEvent(log, k)
        slots.release(k, events[k])
    # every drain after the first two waited on that slot's own event
    for i, entry in enumerate(log):
        if entry[0] == "drain" and i >= 2:
            assert log[i - 1] == ("sync", entry[1])
    assert log[:2] == [("drain", 0), ("drain", 1)]


class _StubTimedEvent:
    def __init__(self, ms):
        self.ms, self.syncs = ms, 0

    def synchronize(self):
        self.syncs += 1

    def elapsed_time(self, stop):
        return stop.ms - self.ms


def test_slot_ring_counts_each_timed_copy_once():
    """The copies' CUDA-event time is summed as each copy is waited on, by
    ``acquire`` or ``settle``, and a copy is counted once (constant state
    over any number of steps)."""
    slots = runner.SlotRing(8, pin=False)
    for step in range(5):
        k, _ = slots.acquire()
        slots.release(k, _StubTimedEvent(10.0 * step + 1.5), _StubTimedEvent(10.0 * step))
    assert (slots.copies, slots.copy_ms) == (3, 4.5)  # the last two copies are still pending
    slots.settle()
    slots.settle()
    assert (slots.copies, slots.copy_ms) == (5, 7.5) and slots.pending == [None, None]


def test_completion_barrier_is_a_no_op_on_the_cpu():
    device.completion_barrier(torch.device("cpu"))
