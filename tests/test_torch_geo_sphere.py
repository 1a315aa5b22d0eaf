"""The sphere geodesy and the tensor ENU transform: the port's
``geo.lat_lng_to_ecef_sphere``, ``ecef_to_lat_lng_sphere``,
``distance_3d_sphere``, ``bearing_distance`` and ``lat_lng_to_enu`` vs the
JAX package's, on the same float32 inputs (JAX runs them in float32, x64
off), and against float64 numpy.

Tolerances and why: an ECEF coordinate near 6.4e6 m has a float32 ulp of
0.5 m, so ECEF within 1 m; latitude and longitude back from ECEF within
1e-5 degrees (≈ 1 m) of the points they came from, and of the
reference's within 1e-5 degrees or two float32 ulps of the angle where
that is larger (both are float32 atan2 of coordinates rounded to 0.5 m;
the reference's own round trip is off by 1.5e-5 degrees past 64); bearings within 1e-3 degrees; great-circle and chord
distances within 1e-6 relative plus 1 m. ENU comes from differences of
float32 ECEF coordinates rotated in float32: each package lands within
1.5 m of the float64 transform, so the two within 2 m of each other. In
float64 the port matches the float64 formulas to 1e-6 m.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radio_mapper_tpu import geo as jgeo

from radio_mapper_tpu_torch import geo
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()


def _points(n, seed):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(-89.0, 89.0, n).astype(np.float32)
    lng = rng.uniform(-180.0, 180.0, n).astype(np.float32)
    alt = rng.uniform(-50.0, 3000.0, n).astype(np.float32)
    return lat, lng, alt


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def test_ecef_sphere_round_trip():
    lat, lng, alt = _points(512, 0)
    ours = geo.lat_lng_to_ecef_sphere(*_t(lat, lng, alt))
    ref = jgeo.lat_lng_to_ecef_sphere(*_j(lat, lng, alt))
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1.0
    back = geo.ecef_to_lat_lng_sphere(*ours)
    jback = jgeo.ecef_to_lat_lng_sphere(*ref)
    for k in (0, 1):
        a, b = back[k].numpy().astype(np.float64), np.asarray(jback[k], np.float64)
        d = (a - b + 180.0) % 360.0 - 180.0
        assert (np.abs(d) <= np.maximum(1e-5, 2 * np.spacing(np.abs(b).astype(np.float32)))).all()
        truth = (lat, lng)[k].astype(np.float64)
        assert np.abs((a - truth + 180.0) % 360.0 - 180.0).max() <= 1e-5
    assert np.abs(back[2].numpy() - np.asarray(jback[2])).max() <= 1.0


def test_distance_and_bearing():
    lat1, lng1, alt1 = _points(512, 1)
    lat2, lng2, alt2 = _points(512, 2)
    # near pairs too: a 50 km network's baselines
    lat2[:256] = lat1[:256] + np.float32(0.3)
    lng2[:256] = lng1[:256] - np.float32(0.2)
    d = geo.distance_3d_sphere(*_t(lat1, lng1, alt1, lat2, lng2, alt2)).numpy()
    jd = np.asarray(jgeo.distance_3d_sphere(*_j(lat1, lng1, alt1, lat2, lng2, alt2)))
    assert (np.abs(d - jd) <= 1e-6 * jd + 1.0).all()
    bearing, dist = geo.bearing_distance(*_t(lat1, lng1, lat2, lng2))
    jb, jdist = jgeo.bearing_distance(*_j(lat1, lng1, lat2, lng2))
    db = (bearing.numpy() - np.asarray(jb) + 180.0) % 360.0 - 180.0
    assert np.abs(db).max() <= 1e-3
    assert ((bearing >= 0) & (bearing < 360)).all()
    assert (np.abs(dist.numpy() - np.asarray(jdist)) <= 1e-6 * np.asarray(jdist) + 1.0).all()


def test_lat_lng_to_enu_tensor():
    ref_lat, ref_lng = np.float32(35.47), np.float32(-97.51)
    rng = np.random.default_rng(3)
    lat = (ref_lat + rng.uniform(-0.3, 0.3, 256)).astype(np.float32)
    lng = (ref_lng + rng.uniform(-0.3, 0.3, 256)).astype(np.float32)
    alt = rng.uniform(0.0, 500.0, 256).astype(np.float32)
    ours = geo.lat_lng_to_enu(*_t(lat, lng, alt), torch.tensor(ref_lat), torch.tensor(ref_lng), 12.0)
    ref = np.asarray(jgeo.lat_lng_to_enu(*_j(lat, lng, alt), jnp.float32(ref_lat), jnp.float32(ref_lng), 12.0))
    assert ours.shape == (256, 3) and ours.dtype == torch.float32
    np64 = np.stack([geo.lat_lng_to_enu_np(a, b, c, float(ref_lat), float(ref_lng), 12.0)
                     for a, b, c in zip(lat, lng, alt)])
    assert np.abs(ours.numpy() - np64).max() <= 1.5
    assert np.abs(ref - np64).max() <= 1.5
    assert np.abs(ours.numpy() - ref).max() <= 2.0
    # float64 tensors agree with the float64 numpy transform
    o64 = geo.lat_lng_to_enu(*_t(lat.astype(np.float64), lng.astype(np.float64), alt.astype(np.float64)),
                             float(ref_lat), float(ref_lng), 12.0)
    assert o64.dtype == torch.float64
    assert np.abs(o64.numpy() - np64).max() <= 1e-6


@pytest.mark.parametrize("case", ["scalars", "broadcast"])
def test_sphere_float64_and_shapes(case):
    if case == "scalars":
        x, y, z = geo.lat_lng_to_ecef_sphere(35.5, -97.5, 100.0)
        assert x.dtype == torch.float32 and x.shape == ()
        gold = geo.lat_lng_to_ecef_sphere(torch.tensor(35.5, dtype=torch.float64), -97.5, 100.0)
        ref = jgeo.lat_lng_to_ecef_sphere_np(35.5, -97.5, 100.0)
        for a, b in zip(gold, ref):
            assert abs(float(a) - float(b)) <= 1e-6
    else:
        lat = torch.linspace(-60, 60, 7, dtype=torch.float64)
        d = geo.distance_3d_sphere(lat, 10.0, 0.0, lat.unsqueeze(-1), 10.5, 0.0)
        assert d.shape == (7, 7) and d.dtype == torch.float64
        b, dist = geo.bearing_distance(lat, 10.0, lat, 10.0)
        assert torch.all(dist.abs() <= 1e-6)
