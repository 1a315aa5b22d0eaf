"""The sharded wideband step: the port's ``build_wideband_sharded_step``
on 2 ranks of ``torch.distributed`` (gloo, a file store, CPU) vs the
port's one-device ``step_split`` and the JAX package's sharded step on 2
virtual CPU devices.

The small config-4 shape of ``tests/test_wideband.py`` (8 buoys, 8
subchannels of 1024 samples, max_lag 64, nfft 2048) on the
``synthesize_wideband`` scene with the emitter in subchannel 3, on both
pair routes (K5 "on", K6 "off", the plain versions on the CPU), in one
launch of 2 ranks. The JAX step runs under the TPU routing in Pallas
interpret mode with ``gcc_kernel.set_onehot_pairs`` forced to the same
route (as ``tests/test_torch_wideband.py``). Tolerances and why:

- against the port's ``step_split``: each rank runs the same per-row
  kernels and per-subchannel solve on half the subchannels, so lags and
  weights within 1e-5 and the active fix within 1e-2 m (only the batch
  sizes of the plain versions' products differ);
- against JAX's sharded step: on the active subchannel lags within 1e-3
  samples, weights within 1e-3 and the fix within 0.5 m, as the port's
  one-device wideband test holds them; quiet subchannels solve noise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from radio_mapper_tpu.models import wideband as jwb
from radio_mapper_tpu.ops.pallas import gcc_kernel

from radio_mapper_tpu_torch.models import wideband
from radio_mapper_tpu_torch.ops.cuda import gcc_pair
from radio_mapper_tpu_torch.parallel import jobs, launch
from radio_mapper_tpu_torch.testing import cap_cpu_threads

from test_torch_cuda import small_wideband_config, wideband_scene
from test_torch_pipeline import _jax_fused_run

cap_cpu_threads()

WORLD = 2
SUB = 3
ROUTES = ("on", "off")
CFG = small_wideband_config()
RE, IM, ANCHORS, EMITTER = wideband_scene(CFG, SUB, 2)


@pytest.fixture(scope="module")
def ranks():
    """``{route: [rank 0, rank 1]}`` outputs of the sharded step."""
    job = lambda route: (jobs.wideband_sharded, dict(config=CFG, re=RE, im=IM, anchors=ANCHORS, onehot=route))
    out = launch.run_ranks(jobs.run_jobs, WORLD, device="cpu", args=([job(r) for r in ROUTES],), timeout_s=600)
    return {route: [out[r][k] for r in range(WORLD)] for k, route in enumerate(ROUTES)}


def _jax_sharded(route):
    def run():
        gcc_kernel.set_onehot_pairs(route)
        try:
            mesh = Mesh(np.array(jax.devices()[:WORLD]), ("sub",))
            step, _ = jwb.build_wideband_sharded_step(mesh, jwb.WidebandConfig(**dataclasses.asdict(CFG)))
            return step(jnp.asarray(RE), jnp.asarray(IM), jnp.asarray(ANCHORS))
        finally:
            gcc_kernel.set_onehot_pairs("auto")

    return _jax_fused_run(run)


@pytest.mark.parametrize("route", ROUTES)
def test_sharded_wideband_equals_step_split_and_jax(ranks, route):
    outs = ranks[route]
    for o in outs[1:]:  # the outputs are gathered on every rank
        for a, b in zip(o[:4], outs[0][:4]):
            np.testing.assert_array_equal(a, b)
    ours = outs[0]
    m, p = CFG.num_subchannels, CFG.num_pairs
    assert ours.fixes_enu.shape == (m, 3) and ours.lags.shape == ours.weights.shape == (m, p)
    assert all(np.isfinite(x).all() for x in ours[:4])

    gcc_pair.set_onehot_pairs(route)
    try:
        one = wideband.WidebandTDOAPipeline(CFG, device="cpu").step_split(
            *(torch.from_numpy(a) for a in (RE, IM, ANCHORS))
        )
    finally:
        gcc_pair.set_onehot_pairs("auto")
    np.testing.assert_allclose(ours.lags, one.lags.numpy(), atol=1e-5)
    np.testing.assert_allclose(ours.weights, one.weights.numpy(), atol=1e-5)
    np.testing.assert_allclose(ours.fixes_enu[SUB], one.fixes_enu[SUB].numpy(), atol=1e-2)
    np.testing.assert_array_equal(ours.channel_offset_hz, one.channel_offset_hz)

    ref = _jax_sharded(route)
    np.testing.assert_allclose(ours.lags[SUB], np.asarray(ref.lags)[SUB], atol=1e-3)
    np.testing.assert_allclose(ours.weights[SUB], np.asarray(ref.weights)[SUB], atol=1e-3)
    np.testing.assert_allclose(ours.fixes_enu[SUB], np.asarray(ref.fixes_enu)[SUB], atol=0.5)
    assert np.linalg.norm(ours.fixes_enu[SUB, :2] - EMITTER[:2]) < 300.0
