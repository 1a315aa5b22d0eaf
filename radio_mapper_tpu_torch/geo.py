"""Geodesy in numpy float64: WGS84 ↔ ECEF, and local ENU tangent frames.

Port of ``radio_mapper_tpu/geo.py``: ``lat_lng_to_enu_np`` (the
simulator's and the engine's forward transform), and
``lat_lng_to_ecef_wgs84``, ``ecef_to_lat_lng_wgs84`` (Bowring's closed
form), ``enu_rotation`` and ``enu_to_lat_lng`` (the engine's fix back to
latitude and longitude), which the reference writes in jnp and runs in
float32 on its default (x64-off) configuration.
"""

from __future__ import annotations

import numpy as np

from radio_mapper_tpu_torch.constants import WGS84_A, WGS84_B, WGS84_E2


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
