"""Geodesy: the spherical Earth of the reference's ECEF helpers, WGS84 ↔
ECEF, and local ENU tangent frames.

Port of ``radio_mapper_tpu/geo.py``. Two halves:

- numpy float64: ``lat_lng_to_enu_np`` (the simulator's and the engine's
  forward transform), ``lat_lng_to_ecef_sphere_np`` (the spherical
  model's golden), and ``lat_lng_to_ecef_wgs84``,
  ``ecef_to_lat_lng_wgs84`` (Bowring's closed form), ``enu_rotation`` and
  ``enu_to_lat_lng`` (the engine's fix back to latitude and longitude),
  which the reference writes in jnp and runs in float32 on its default
  (x64-off) configuration;
- torch, on the device and in the dtype of the input tensors: the
  spherical model (``lat_lng_to_ecef_sphere``, ``ecef_to_lat_lng_sphere``,
  ``distance_3d_sphere``, ``bearing_distance``) and the tensor ENU
  transform ``lat_lng_to_enu``. In float32 an ECEF coordinate near
  6.4e6 m has an ulp of 0.5 m, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from radio_mapper_tpu_torch.constants import EARTH_RADIUS_M, WGS84_A, WGS84_B, WGS84_E2


def _tensors(*xs):
    """``xs`` as tensors of one dtype and device: those of the first tensor
    among them (float32 on the CPU when none is a tensor)."""
    like = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    dtype = like.dtype if like is not None and like.is_floating_point() else torch.float32
    dev = like.device if like is not None else None
    return [torch.as_tensor(x, dtype=dtype, device=dev) for x in xs]


# --- Spherical model (the reference's parity helpers) ------------------------


def lat_lng_to_ecef_sphere(lat_deg, lng_deg, alt_m=0.0):
    """Spherical ECEF: (R+alt)·[cosφcosλ, cosφsinλ, sinφ]."""
    lat_deg, lng_deg, alt_m = _tensors(lat_deg, lng_deg, alt_m)
    lat = torch.deg2rad(lat_deg)
    lng = torch.deg2rad(lng_deg)
    r = EARTH_RADIUS_M + alt_m
    cos_lat = torch.cos(lat)
    return r * cos_lat * torch.cos(lng), r * cos_lat * torch.sin(lng), r * torch.sin(lat)


def ecef_to_lat_lng_sphere(x, y, z):
    """Inverse spherical transform: ``(lat_deg, lng_deg, alt_m)``."""
    x, y, z = _tensors(x, y, z)
    lng = torch.atan2(y, x)
    lat = torch.atan2(z, torch.sqrt(x * x + y * y))
    alt = torch.sqrt(x * x + y * y + z * z) - EARTH_RADIUS_M
    return torch.rad2deg(lat), torch.rad2deg(lng), alt


def distance_3d_sphere(lat1, lng1, alt1, lat2, lng2, alt2):
    """Chord distance between two points on the spherical model."""
    p1 = torch.stack(torch.broadcast_tensors(*lat_lng_to_ecef_sphere(lat1, lng1, alt1)), dim=-1)
    p2 = torch.stack(torch.broadcast_tensors(*lat_lng_to_ecef_sphere(lat2, lng2, alt2)), dim=-1)
    return torch.linalg.vector_norm(p2 - p1, dim=-1)


def bearing_distance(lat1, lng1, lat2, lng2):
    """Haversine great-circle distance and initial bearing:
    ``(bearing_deg in [0, 360), distance_m)``."""
    lat1, lng1, lat2, lng2 = _tensors(lat1, lng1, lat2, lng2)
    phi1 = torch.deg2rad(lat1)
    phi2 = torch.deg2rad(lat2)
    dlng = torch.deg2rad(lng2 - lng1)
    a = torch.sin((phi2 - phi1) / 2) ** 2 + torch.cos(phi1) * torch.cos(phi2) * torch.sin(dlng / 2) ** 2
    c = 2.0 * torch.atan2(torch.sqrt(a), torch.sqrt(1.0 - a))
    y = torch.sin(dlng) * torch.cos(phi2)
    x = torch.cos(phi1) * torch.sin(phi2) - torch.sin(phi1) * torch.cos(phi2) * torch.cos(dlng)
    bearing = torch.remainder(torch.rad2deg(torch.atan2(y, x)) + 360.0, 360.0)
    return bearing, EARTH_RADIUS_M * c


def _ecef_wgs84_t(lat_deg, lng_deg, alt_m):
    lat = torch.deg2rad(lat_deg)
    lng = torch.deg2rad(lng_deg)
    sin_lat = torch.sin(lat)
    n = WGS84_A / torch.sqrt(1.0 - WGS84_E2 * sin_lat * sin_lat)
    cos_lat = torch.cos(lat)
    return ((n + alt_m) * cos_lat * torch.cos(lng), (n + alt_m) * cos_lat * torch.sin(lng),
            (n * (1.0 - WGS84_E2) + alt_m) * sin_lat)


def lat_lng_to_enu(lat_deg, lng_deg, alt_m, ref_lat_deg, ref_lng_deg, ref_alt_m=0.0):
    """ENU meters ``[..., 3]`` of points relative to a reference origin
    (WGS84), on tensors: the reference's jnp ``lat_lng_to_enu``."""
    lat_deg, lng_deg, alt_m, ref_lat_deg, ref_lng_deg, ref_alt_m = _tensors(
        lat_deg, lng_deg, alt_m, ref_lat_deg, ref_lng_deg, ref_alt_m)
    p = torch.stack(torch.broadcast_tensors(*_ecef_wgs84_t(lat_deg, lng_deg, alt_m)), dim=-1)
    o = torch.stack(torch.broadcast_tensors(*_ecef_wgs84_t(ref_lat_deg, ref_lng_deg, ref_alt_m)), dim=-1)
    lat = torch.deg2rad(ref_lat_deg)
    lng = torch.deg2rad(ref_lng_deg)
    sl, cl, so, co = torch.sin(lat), torch.cos(lat), torch.sin(lng), torch.cos(lng)
    rot = torch.stack(torch.broadcast_tensors(
        torch.stack(torch.broadcast_tensors(-so, co, torch.zeros_like(so)), dim=-1),
        torch.stack(torch.broadcast_tensors(-sl * co, -sl * so, cl), dim=-1),
        torch.stack(torch.broadcast_tensors(cl * co, cl * so, sl), dim=-1)), dim=-2)
    d = p - o
    # the reference's einsum "...ij,...j->...i" as elementwise products:
    # a float32 matmul could run in TF32 on the card
    return (rot * d.unsqueeze(-2)).sum(-1)


def lat_lng_to_ecef_wgs84(lat_deg, lng_deg, alt_m=0.0):
    """ECEF (x, y, z) meters of geodetic points (WGS84)."""
    lat = np.deg2rad(np.asarray(lat_deg, dtype=np.float64))
    lng = np.deg2rad(np.asarray(lng_deg, dtype=np.float64))
    sin_lat = np.sin(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat * sin_lat)
    cos_lat = np.cos(lat)
    x = (n + alt_m) * cos_lat * np.cos(lng)
    y = (n + alt_m) * cos_lat * np.sin(lng)
    z = (n * (1.0 - WGS84_E2) + alt_m) * sin_lat
    return x, y, z


def ecef_to_lat_lng_wgs84(x, y, z):
    """Bowring's closed-form inverse (sub-mm for terrestrial points):
    ``(lat_deg, lng_deg, alt_m)``."""
    lng = np.arctan2(y, x)
    p = np.sqrt(x * x + y * y)
    theta = np.arctan2(z * WGS84_A, p * WGS84_B)
    ep2 = (WGS84_A**2 - WGS84_B**2) / WGS84_B**2
    lat = np.arctan2(
        z + ep2 * WGS84_B * np.sin(theta) ** 3,
        p - WGS84_E2 * WGS84_A * np.cos(theta) ** 3,
    )
    sin_lat = np.sin(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat * sin_lat)
    alt = p / np.cos(lat) - n
    return np.rad2deg(lat), np.rad2deg(lng), alt


def enu_rotation(lat_deg, lng_deg) -> np.ndarray:
    """``[..., 3, 3]``: rows are the local east/north/up unit vectors in ECEF."""
    lat = np.deg2rad(np.asarray(lat_deg, dtype=np.float64))
    lng = np.deg2rad(np.asarray(lng_deg, dtype=np.float64))
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lng), np.cos(lng)
    return np.stack(
        [
            np.stack([-so, co, np.zeros_like(so)], axis=-1),
            np.stack([-sl * co, -sl * so, cl], axis=-1),
            np.stack([cl * co, cl * so, sl], axis=-1),
        ],
        axis=-2,
    )


def enu_to_lat_lng(enu, ref_lat_deg, ref_lng_deg, ref_alt_m=0.0):
    """Geodetic ``(lat_deg, lng_deg, alt_m)`` of ENU points ``[..., 3]``
    relative to a reference origin: the inverse of :func:`lat_lng_to_enu_np`."""
    enu = np.asarray(enu, dtype=np.float64)
    o = np.stack(lat_lng_to_ecef_wgs84(ref_lat_deg, ref_lng_deg, ref_alt_m), axis=-1)
    rot = enu_rotation(ref_lat_deg, ref_lng_deg)
    p = o + np.einsum("...ji,...j->...i", rot, enu)
    return ecef_to_lat_lng_wgs84(p[..., 0], p[..., 1], p[..., 2])


def lat_lng_to_ecef_sphere_np(lat_deg, lng_deg, alt_m=0.0):
    """Spherical ECEF in numpy float64: the golden of
    :func:`lat_lng_to_ecef_sphere`."""
    lat = np.deg2rad(np.asarray(lat_deg, dtype=np.float64))
    lng = np.deg2rad(np.asarray(lng_deg, dtype=np.float64))
    r = EARTH_RADIUS_M + np.asarray(alt_m, dtype=np.float64)
    return r * np.cos(lat) * np.cos(lng), r * np.cos(lat) * np.sin(lng), r * np.sin(lat)


def lat_lng_to_enu_np(lat_deg, lng_deg, alt_m, ref_lat, ref_lng, ref_alt=0.0) -> np.ndarray:
    """ENU meters (float64) of a point relative to a reference origin (WGS84)."""

    def ecef(la, lo, al):
        la, lo = np.deg2rad(float(la)), np.deg2rad(float(lo))
        sin_lat = np.sin(la)
        n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat**2)
        return np.array(
            [
                (n + al) * np.cos(la) * np.cos(lo),
                (n + al) * np.cos(la) * np.sin(lo),
                (n * (1.0 - WGS84_E2) + al) * sin_lat,
            ]
        )

    p = ecef(lat_deg, lng_deg, alt_m)
    o = ecef(ref_lat, ref_lng, ref_alt)
    la, lo = np.deg2rad(float(ref_lat)), np.deg2rad(float(ref_lng))
    rot = np.array(
        [
            [-np.sin(lo), np.cos(lo), 0.0],
            [-np.sin(la) * np.cos(lo), -np.sin(la) * np.sin(lo), np.cos(la)],
            [np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo), np.sin(la)],
        ]
    )
    return rot @ (p - o)
