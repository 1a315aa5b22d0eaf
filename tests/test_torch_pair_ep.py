"""Pair-parallel (EP): the port's psum'd solve and EP step on 4 ranks of
``torch.distributed`` (gloo, a file store, CPU) vs the port's local solve
and the JAX package's EP step on 4 virtual CPU devices.

Every port-side computation runs in one launch of 4 ranks (module
fixture ``ranks``). Tolerances and why:

- the psum'd solve against the local solve and JAX's EP solve (17 buoys,
  136 pairs, 34 a rank; and 9 buoys padded to 40 pairs with rank 0's
  pairs all masked): fixes within 0.5 m (gloo sums the normal equations
  in another order than one device or JAX's psum; the LM's
  ``cost_new < cost`` may then branch apart on a near-tie, and the
  reference's own sharded-vs-local bar is 0.5 m);
- the EP step on the 8-buoy scene of ``tests/test_pair_ep.py`` (28
  pairs, 7 a rank) and on a 12-buoy one (66 pairs padded to 68: the two
  padding pairs carry pair (0, 1) at weight 0), on both routes: unfused
  against JAX's unfused, and fused (forced "on": the plain versions of
  K3 and K5) against JAX's fused chain in Pallas interpret mode: lags
  within 1e-3 samples, weights within 1e-3, fixes within 0.5 m, and the
  fix within 100 m of the emitter (the reference's bar);
- every rank holds the identical fix (bit for bit) in every case, as the
  psum makes it;
- 64 buoys (2016 pairs) on noise: shapes, finiteness and the ellipse
  fields (major ≥ minor ≥ 0, bearing in [0, 180)), as the reference's
  tests check them.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from radio_mapper_tpu import solver as jsolver
from radio_mapper_tpu.parallel import pair_ep as jpair_ep

from radio_mapper_tpu_torch import sim, solver
from radio_mapper_tpu_torch.ops import gcc_phat
from radio_mapper_tpu_torch.parallel import jobs, launch
from radio_mapper_tpu_torch.parallel.pair_ep import PairEPConfig, _padded_pairs
from radio_mapper_tpu_torch.testing import cap_cpu_threads

from test_torch_pipeline import _jax_fused_run

cap_cpu_threads()

WORLD = 4


def _synthetic_case(num_buoys, seed):
    """Random geometry + exact dd from a known emitter, 5 m noise, mild
    weight spread (``tests/test_pair_ep.py``)."""
    rng = np.random.default_rng(seed)
    anchors = rng.normal(scale=8_000.0, size=(num_buoys, 3)).astype(np.float32)
    anchors[:, 2] = 0.0
    emitter = np.array([1500.0, -2200.0, 0.0], np.float32)
    i_idx, j_idx = gcc_phat.pair_indices(num_buoys)
    d = np.linalg.norm(anchors - emitter, axis=1)
    dd = (d[i_idx] - d[j_idx]).astype(np.float32)
    dd += rng.normal(scale=5.0, size=dd.shape).astype(np.float32)
    w = rng.uniform(0.2, 1.0, size=dd.shape).astype(np.float32)
    return anchors, i_idx, j_idx, dd, w, emitter


SOLVE = _synthetic_case(17, 0)  # 136 pairs = 4 · 34
MASKED = _synthetic_case(9, 3)  # 36 pairs, padded to 40
MASKED_PAD = 4
MASKED_W = np.concatenate([MASKED[4][:10] * 0.0, MASKED[4][10:]])  # rank 0's 10 pairs all masked


def _padded(case, w, pad):
    anchors, i_idx, j_idx, dd = case[:4]
    return dict(
        anchors=anchors,
        pair_i=np.concatenate([i_idx, np.zeros(pad, np.int32)]),
        pair_j=np.concatenate([j_idx, np.ones(pad, np.int32)]),
        dd=np.concatenate([dd, np.zeros(pad, np.float32)]),
        weights=np.concatenate([w, np.zeros(pad, np.float32)]),
    )


def _scene(num_buoys):
    scen = sim.default_scenario(
        block_len=4096, snr_db=25.0, seed=11, bandwidth_hz=500e3,
        buoys=[(f"b{k}", 35.40 + 0.05 * (k % 4), -97.60 + 0.06 * (k // 4), 0.0) for k in range(num_buoys)],
    )
    cap = sim.synthesize(scen)
    cfg = PairEPConfig(num_buoys=num_buoys, block_len=4096, sample_rate_hz=scen.sample_rate_hz, max_lag=256)
    return cfg, cap


SCENES = {b: _scene(b) for b in (8, 12)}


def _scene_args(b):
    cfg, cap = SCENES[b]
    return dict(config=cfg, re=cap.iq.real.astype(np.float32), im=cap.iq.imag.astype(np.float32),
                anchors=cap.buoy_enu.astype(np.float32))


def _noise_args(b, n, max_lag, iterations, seed):
    rng = np.random.default_rng(seed)
    cfg = PairEPConfig(num_buoys=b, block_len=n, sample_rate_hz=2_048_000.0, max_lag=max_lag,
                       solver_iterations=iterations)
    re, im = (rng.normal(size=(b, n)).astype(np.float32) for _ in range(2))
    anchors = rng.normal(scale=5_000.0, size=(b, 3)).astype(np.float32)
    anchors[:, 2] = 0.0
    return dict(config=cfg, re=re, im=im, anchors=anchors)


JOBS = {
    "solve": (jobs.ep_solve, dict(**_padded(SOLVE, SOLVE[4], 0), iterations=30)),
    "solve_masked": (jobs.ep_solve, dict(**_padded(MASKED, MASKED_W, MASKED_PAD), iterations=30)),
    **{f"scene{b}_{route}": (jobs.ep_step, dict(**_scene_args(b), fused="on" if route == "fused" else "auto"))
       for b in SCENES for route in ("unfused", "fused")},
    "noise64": (jobs.ep_step, _noise_args(64, 2048, 128, 10, 0)),
    "ellipse": (jobs.ep_step, _noise_args(8, 1024, 64, 8, 1)),
}


@pytest.fixture(scope="module")
def ranks():
    """Each job's result on each rank: ``{name: [rank 0, ..., rank 3]}``."""
    out = launch.run_ranks(jobs.run_jobs, WORLD, device="cpu", args=(list(JOBS.values()),), timeout_s=600)
    return {name: [out[r][k] for r in range(WORLD)] for k, name in enumerate(JOBS)}


def _jax_mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("pair",))


def _jax_ep_solve(args, iterations):
    f = jax.shard_map(
        lambda anc, pi, pj, dd, w: jsolver.solve_tdoa(anc, pi, pj, dd, w, iterations=iterations,
                                                       axis_name="pair").position_enu,
        mesh=_jax_mesh(), in_specs=(P(), P("pair"), P("pair"), P("pair"), P("pair")), out_specs=P(),
        check_vma=False,
    )
    return np.asarray(jax.jit(f)(*(jnp.asarray(args[k]) for k in ("anchors", "pair_i", "pair_j", "dd", "weights"))))


def _same_on_every_rank(outs):
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    return outs[0]


@pytest.mark.parametrize("case", ["solve", "solve_masked"])
def test_psum_solve_equals_local_and_jax(ranks, case):
    fix = _same_on_every_rank(ranks[case])
    anchors, i_idx, j_idx, dd, w, emitter = SOLVE if case == "solve" else MASKED
    if case == "solve_masked":
        w = MASKED_W
    t = lambda a: torch.from_numpy(np.asarray(a))
    local = solver.solve_tdoa(t(anchors), t(i_idx), t(j_idx), t(dd), t(w), iterations=30).position_enu.numpy()
    np.testing.assert_allclose(fix, local, atol=0.5)
    np.testing.assert_allclose(fix, _jax_ep_solve(JOBS[case][1], 30), atol=0.5)
    assert np.linalg.norm(fix[:2] - emitter[:2]) < 50.0


def _jax_ep_step(args, fused):
    jcfg = jpair_ep.PairEPConfig(**dataclasses.asdict(args["config"]))

    def run():
        step, _, _ = jpair_ep.build_pair_ep_step(_jax_mesh(), jcfg)
        return step(*(jnp.asarray(args[k]) for k in ("re", "im", "anchors")))

    out = _jax_fused_run(run) if fused else run()
    return type(out)(*(np.asarray(v) for v in out))


@pytest.mark.parametrize("route", ["unfused", "fused"])
@pytest.mark.parametrize("b", sorted(SCENES))
def test_ep_step_matches_jax_on_scenes(ranks, b, route):
    outs = ranks[f"scene{b}_{route}"]
    for field in ("fix_enu", "cost", "ellipse_major_m", "ellipse_minor_m", "ellipse_orientation_deg"):
        _same_on_every_rank([getattr(o, field) for o in outs])
    ours = outs[0]
    args = JOBS[f"scene{b}_{route}"][1]
    cfg, cap = SCENES[b]
    ref = _jax_ep_step(args, route == "fused")
    p = cfg.num_pairs
    p_pad = len(_padded_pairs(b, WORLD)[0])
    assert ours.lags.shape == ours.weights.shape == ref.lags.shape == (p_pad,)
    np.testing.assert_allclose(ours.lags[:p], ref.lags[:p], atol=1e-3)
    np.testing.assert_allclose(ours.weights, ref.weights, atol=1e-3)
    np.testing.assert_array_equal(ours.weights[p:], 0.0)  # the padding pairs are masked
    np.testing.assert_allclose(ours.fix_enu, ref.fix_enu, atol=0.5)
    assert np.linalg.norm(ours.fix_enu[:2] - cap.emitter_enu[0][:2]) < 100.0


def test_ep_step_64_buoys_and_ellipse_fields(ranks):
    outs = ranks["noise64"]
    _same_on_every_rank([o.fix_enu for o in outs])
    out = outs[0]
    assert len(_padded_pairs(64, WORLD)[0]) == 2016 and out.lags.shape == (2016,)
    assert out.fix_enu.shape == (3,) and np.isfinite(out.cost) and np.isfinite(out.lags).all()
    assert (np.abs(out.lags) <= 128).all()
    for o in (out, ranks["ellipse"][0]):
        major, minor, brg = (float(o.ellipse_major_m), float(o.ellipse_minor_m), float(o.ellipse_orientation_deg))
        assert np.isfinite([major, minor, brg]).all()
        assert major >= minor >= 0.0
        assert 0.0 <= brg < 180.0
