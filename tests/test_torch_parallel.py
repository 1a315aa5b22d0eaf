"""The multi-device layer: the port's meshes, halos, sharded channelizer
and sharded steps on ranks of ``torch.distributed`` (gloo, a file store,
CPU) vs the JAX package's on its virtual CPU devices.

Every port-side computation of this file runs in one launch of 4 ranks
(:func:`radio_mapper_tpu_torch.parallel.launch.run_ranks`, module
fixture ``ranks``); the JAX side runs on 4 of the 8 devices of
``tests/conftest.py``. Tolerances and why:

- ``balanced_mesh_shape`` equal for n = 1..16; halos equal bit for bit
  (copies and zeros): left and right, with and without wrap, on a
  (1, 4) mesh and on a (4, 1) mesh (the one-shard branch);
- ``sharded_channelize``, the ranks' frames concatenated, equal to the
  port's ``StreamingChannelizer`` bit for bit (the same sums of the same
  values), and within 1e-5 of the largest sample of JAX's (the branch DFT
  is the port's matmul DFT against XLA's FFT, as
  ``tests/test_torch_streaming.py``);
- the complex and split sharded steps on a (2, 2) mesh against JAX's on
  scenes with an emitter: on the subchannels where the emitter's
  correlation peaks stand clear (JAX's mean pair weight above 0.5), lags
  within 1e-3 samples, weights within 1e-3, fixes within 0.5 m; noise
  subchannels have no stable argmax between two implementations and are
  checked only for shape and finiteness. The split step on the CPU takes
  the natural-order split GCC (the reference's route off the TPU) and,
  forced with ``set_gcc_fused("on")``, the fused chain's plain versions
  (K3, then K2), against JAX's fused chain in Pallas interpret mode;
- the port's own consistency on noise (JAX's ``tests/test_parallel.py``
  bars): the split step equals the complex step (lags 5e-3, weights
  1e-2), and time shard 0 of the (2, 2) run equals the run of a (4, 1)
  mesh on shard 0's samples alone (lags 1e-3).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from radio_mapper_tpu.models import streaming as jstreaming
from radio_mapper_tpu.parallel import halo as jhalo
from radio_mapper_tpu.parallel import mesh as jmesh
from radio_mapper_tpu.parallel import sharded as jsharded

from radio_mapper_tpu_torch import sim
from radio_mapper_tpu_torch.models.streaming import StreamingChannelizer
from radio_mapper_tpu_torch.parallel import jobs, launch, mesh as mesh_lib
from radio_mapper_tpu_torch.parallel.sharded import ShardedStepConfig
from radio_mapper_tpu_torch.testing import cap_cpu_threads

from test_torch_pipeline import _jax_fused_run

cap_cpu_threads()

WORLD = 4
HALO_X = np.arange(2 * 32, dtype=np.float32).reshape(2, 32)
HALO_LEN = 3
CHAN = dict(num_channels=8, sample_rate_hz=2_048_000.0, taps_per_channel=4)
STREAM = (np.random.default_rng(1).normal(size=(2, 4 * 512))
          + 1j * np.random.default_rng(2).normal(size=(2, 4 * 512))).astype(np.complex64)
SCENE_CFG = ShardedStepConfig(num_channels=4, num_buoys=4, num_subchannels=8, max_lag=16, solver_iterations=15)
NOISE_CFG = ShardedStepConfig(num_channels=4, num_buoys=3, num_subchannels=4, max_lag=8)
MESH = (2, 2)


def _scene():
    """``[C, B, N]`` complex64: per channel an OKC capture (4 buoys, a
    150 kHz noise emitter at baseband) of its own seed and emitter place,
    and the anchors."""
    n = MESH[1] * 2048
    caps = [
        sim.synthesize(sim.default_scenario(
            signal="noise", bandwidth_hz=150e3, snr_db=25.0, block_len=n, seed=10 + c,
            emitter_lat=35.47 + 0.01 * c, emitter_lng=-97.51 + 0.012 * c,
        ))
        for c in range(SCENE_CFG.num_channels)
    ]
    return np.stack([c.iq for c in caps]).astype(np.complex64), caps[0].buoy_enu.astype(np.float32)


SCENE_X, SCENE_ANCHORS = _scene()


def _noise_inputs():
    rng = np.random.default_rng(5)
    shape = (NOISE_CFG.num_channels, NOISE_CFG.num_buoys, MESH[1] * 256)
    re, im = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    anchors = rng.normal(scale=5_000.0, size=(NOISE_CFG.num_buoys, 3)).astype(np.float32)
    anchors[:, 2] = 0.0
    return re, im, anchors


NOISE_RE, NOISE_IM, NOISE_ANCHORS = _noise_inputs()

JOBS = {
    "halo_1x4": (jobs.halos, dict(x=HALO_X, halo_len=HALO_LEN, mesh_shape=(1, 4))),
    "halo_4x1": (jobs.halos, dict(x=HALO_X, halo_len=HALO_LEN, mesh_shape=(4, 1))),
    "channelize": (jobs.channelize, dict(x=STREAM, **CHAN)),
    "scene_complex": (jobs.sharded_step, dict(config=SCENE_CFG, x=(SCENE_X,), anchors=SCENE_ANCHORS,
                                              mesh_shape=MESH, split=False)),
    "scene_split": (jobs.sharded_step, dict(config=SCENE_CFG, x=(SCENE_X.real.copy(), SCENE_X.imag.copy()),
                                            anchors=SCENE_ANCHORS, mesh_shape=MESH, split=True)),
    "scene_split_fused": (jobs.sharded_step, dict(config=SCENE_CFG, x=(SCENE_X.real.copy(), SCENE_X.imag.copy()),
                                                  anchors=SCENE_ANCHORS, mesh_shape=MESH, split=True, fused="on")),
    "noise_complex": (jobs.sharded_step, dict(config=NOISE_CFG, x=(NOISE_RE + 1j * NOISE_IM,),
                                              anchors=NOISE_ANCHORS, mesh_shape=MESH, split=False)),
    "noise_split": (jobs.sharded_step, dict(config=NOISE_CFG, x=(NOISE_RE, NOISE_IM),
                                            anchors=NOISE_ANCHORS, mesh_shape=MESH, split=True)),
    "noise_split_4x1": (jobs.sharded_step, dict(config=NOISE_CFG, x=(NOISE_RE[..., :256], NOISE_IM[..., :256]),
                                                anchors=NOISE_ANCHORS, mesh_shape=(4, 1), split=True)),
}


@pytest.fixture(scope="module")
def ranks():
    """Each job's result on each rank: ``{name: [rank 0, ..., rank 3]}``."""
    out = launch.run_ranks(jobs.run_jobs, WORLD, device="cpu", args=(list(JOBS.values()),), timeout_s=600)
    return {name: [out[r][k] for r in range(WORLD)] for k, name in enumerate(JOBS)}


def _jax_mesh(shape, names=("ch", "blk")):
    return jmesh.make_mesh(shape, names, devices=jax.devices()[:int(np.prod(shape))])


@pytest.mark.parametrize("n", range(1, 17))
def test_balanced_mesh_shape_matches_jax(n):
    assert mesh_lib.balanced_mesh_shape(n) == jmesh.balanced_mesh_shape(n)


def _jax_halo(kind, wrap, shape):
    fn = getattr(jhalo, kind)
    m = _jax_mesh(shape)
    f = jax.shard_map(lambda x: fn(x, "blk", HALO_LEN, wrap=wrap), mesh=m,
                      in_specs=P(None, "blk"), out_specs=P(None, "blk"))
    return np.asarray(jax.jit(f)(jnp.asarray(HALO_X)))


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("kind", ["left_halo", "right_halo", "with_left_halo", "with_right_halo"])
@pytest.mark.parametrize("shape", [(1, 4), (4, 1)])
def test_halos_equal_jax(ranks, shape, kind, wrap):
    key = f"{kind.replace('_halo', '')}{'_wrap' if wrap else ''}"
    per_rank = [r[key] for r in ranks[f"halo_{shape[0]}x{shape[1]}"]]
    blk = [np.unravel_index(r, shape)[1] for r in range(WORLD)]
    # the blocks in "blk" order (on the (4, 1) mesh every rank holds the whole row)
    ours = np.concatenate([per_rank[blk.index(b)] for b in range(shape[1])], axis=-1)
    np.testing.assert_array_equal(ours, _jax_halo(kind, wrap, shape))
    if shape == (1, 4) and kind == "left_halo":  # shard 0: zeros unless wrapped
        np.testing.assert_array_equal(per_rank[0], HALO_X[:, -HALO_LEN:] if wrap else 0 * HALO_X[:, :HALO_LEN])


def test_sharded_channelize_equals_stream_and_jax(ranks):
    frames = ranks["channelize"]
    for r in range(1, WORLD):
        np.testing.assert_array_equal(frames[r], frames[0])
    sc = StreamingChannelizer(CHAN["num_channels"], sample_rate_hz=CHAN["sample_rate_hz"],
                              taps_per_channel=CHAN["taps_per_channel"], device="cpu")
    st, outs = sc.init_state((2,)), []
    per = STREAM.shape[-1] // WORLD
    for k in range(WORLD):
        st, o = sc.step(st, torch.from_numpy(STREAM[..., k * per:(k + 1) * per]))
        outs.append(o.channels.numpy())
    np.testing.assert_array_equal(frames[0], np.concatenate(outs, axis=-1))

    m = jmesh.make_mesh((WORLD,), ("blk",), devices=jax.devices()[:WORLD])
    f = jax.shard_map(
        lambda x: jstreaming.sharded_channelize(x, CHAN["num_channels"], sample_rate_hz=CHAN["sample_rate_hz"],
                                                taps_per_channel=CHAN["taps_per_channel"]).channels,
        mesh=m, in_specs=P(None, "blk"), out_specs=P(None, None, "blk"),
    )
    ref = np.asarray(jax.jit(f)(jnp.asarray(STREAM)))
    assert frames[0].shape == ref.shape
    assert np.abs(frames[0] - ref).max() <= 1e-5 * np.abs(ref).max()


def _jax_step(split, x, anchors, cfg, shape=MESH, fused=False):
    jcfg = jsharded.ShardedStepConfig(**dataclasses.asdict(cfg))
    m = _jax_mesh(shape)

    def run():
        if split:
            step, _ = jsharded.build_sharded_step_split(m, jcfg)
            return step(jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()), jnp.asarray(anchors))
        step, _ = jsharded.build_sharded_step(m, jcfg)
        return step(jnp.asarray(x), jnp.asarray(anchors))

    out = _jax_fused_run(run) if fused else run()
    return type(out)(*(np.asarray(v) for v in out))


def _assert_outputs_shaped(out, cfg, s):
    c, mm, p = cfg.num_channels, cfg.num_subchannels, cfg.num_pairs
    assert out.fixes_enu.shape == (s, c, mm, 3) and out.cost.shape == (s, c, mm)
    assert out.lags.shape == out.weights.shape == (s, c, mm, p)
    assert all(np.isfinite(v).all() for v in out)
    assert (np.abs(out.lags) <= cfg.max_lag).all()


@pytest.mark.parametrize("route", ["complex", "split", "split_fused"])
def test_sharded_step_matches_jax_on_scenes(ranks, route):
    outs = ranks[f"scene_{route}"]
    for o in outs[1:]:  # every rank gathers the same global outputs
        for a, b in zip(o, outs[0]):
            np.testing.assert_array_equal(a, b)
    ours = outs[0]
    ref = _jax_step(route != "complex", SCENE_X, SCENE_ANCHORS, SCENE_CFG, fused=route == "split_fused")
    _assert_outputs_shaped(ours, SCENE_CFG, MESH[1])
    strong = ref.weights.mean(axis=-1) > 0.5  # [S, C, M]
    assert strong.sum() >= SCENE_CFG.num_channels * MESH[1], strong.sum()
    np.testing.assert_allclose(ours.lags[strong], ref.lags[strong], atol=1e-3)
    np.testing.assert_allclose(ours.weights[strong], ref.weights[strong], atol=1e-3)
    np.testing.assert_allclose(ours.fixes_enu[strong], ref.fixes_enu[strong], atol=0.5)


def test_split_step_matches_complex_step(ranks):
    c, s = ranks["noise_complex"][0], ranks["noise_split"][0]
    _assert_outputs_shaped(s, NOISE_CFG, MESH[1])
    np.testing.assert_allclose(s.lags, c.lags, atol=5e-3)
    np.testing.assert_allclose(s.weights, c.weights, atol=1e-2)


def test_time_shard_zero_equals_its_samples_alone(ranks):
    sharded, alone = ranks["noise_split"][0], ranks["noise_split_4x1"][0]
    assert alone.lags.shape[0] == 1
    np.testing.assert_allclose(sharded.lags[0], alone.lags[0], atol=1e-3)
