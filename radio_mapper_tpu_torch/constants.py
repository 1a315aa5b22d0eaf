"""Constants the ported slice uses, copied from the JAX package.

Values equal ``radio_mapper_tpu/constants.py`` and ``ops/iq.py``
(``UINT8_OFFSET``); a test asserts the equality.
"""

from __future__ import annotations

# --- Physics
SPEED_OF_LIGHT_M_S = 299_792_458.0

# --- WGS84 ellipsoid (geo.lat_lng_to_enu_np)
WGS84_A = 6_378_137.0
WGS84_F = 1.0 / 298.257223563
WGS84_B = WGS84_A * (1.0 - WGS84_F)
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)

# --- RTL-SDR sample rate default
DEFAULT_SAMPLE_RATE_HZ = 2_048_000

# --- Detection defaults
DEFAULT_DETECTION_THRESHOLD_DBM = -70.0
DEFAULT_CONFIDENCE_FLOOR = 0.3
DEFAULT_SNR_FULLSCALE_DB = 20.0  # confidence = SNR / 20, clipped to [0, 1]
DEFAULT_DC_NOTCH_HZ = 10_000.0  # skip ±10 kHz around the tuned center
DEFAULT_PEAK_MIN_DISTANCE_BINS = 10
DEFAULT_BLOCK_SAMPLES = 16_384

# --- uint8 IQ decode offset (dongle bytes are centered at 127.5)
UINT8_OFFSET = 127.5
