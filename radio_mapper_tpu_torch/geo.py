"""Geodesy: the numpy WGS84 → local ENU transform the simulator needs."""

from __future__ import annotations

import numpy as np

from radio_mapper_tpu_torch.constants import WGS84_A, WGS84_E2


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
