"""Hardware/interface autodetection.

Parity with `config_manager.py:389-436`: local IP via the UDP-connect
trick, GPS serial device probing, SDR enumeration via ``rtl_test -t``
output parsing — every probe degrades gracefully when the hardware or
binary is absent (this framework must set up cleanly on a host with no
SDR attached).

Port of ``radio_mapper_tpu/config/autodetect.py``; the accelerator entry
of the report is the CUDA card, under the key ``gpu``.
"""

from __future__ import annotations

import glob
import re
import socket
import subprocess
from typing import Dict, List


def detect_local_ip() -> str:
    """Local IP without sending packets (`config_manager.py:389-397`)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("8.8.8.8", 80))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


def detect_gps_devices() -> List[str]:
    """Candidate GPS serial devices (`config_manager.py:399-417`)."""
    return sorted(
        glob.glob("/dev/ttyACM*") + glob.glob("/dev/ttyUSB*") + glob.glob("/dev/pps*")
    )


def detect_sdr_count(binary: str = "rtl_test", timeout_s: float = 5.0) -> int:
    """Count RTL-SDR dongles via ``rtl_test -t`` (`config_manager.py:419-436`).

    Returns 0 when the binary or hardware is absent.
    """
    try:
        proc = subprocess.run(
            [binary, "-t"],
            capture_output=True,
            text=True,
            timeout=timeout_s,
        )
    except (FileNotFoundError, subprocess.TimeoutExpired, OSError):
        return 0
    output = proc.stdout + proc.stderr
    m = re.search(r"Found (\d+) device", output)
    return int(m.group(1)) if m else 0


def detect_gpu() -> Dict:
    """CUDA card visibility through ``torch.cuda``: the name and count
    that :class:`radio_mapper_tpu_torch.device.CardInfo` carries."""
    try:
        import torch

        if not torch.cuda.is_available():
            return {"backend": "unavailable", "num_devices": 0}
        return {
            "backend": "cuda",
            "num_devices": torch.cuda.device_count(),
            "name": torch.cuda.get_device_name(0),
        }
    except Exception as e:  # pragma: no cover - env specific
        return {"backend": "unavailable", "error": str(e), "num_devices": 0}


def auto_detect_interfaces() -> Dict:
    """Full detection report (`config_manager.py:378-388` analog)."""
    return {
        "local_ip": detect_local_ip(),
        "gps_devices": detect_gps_devices(),
        "sdr_count": detect_sdr_count(),
        "gpu": detect_gpu(),
    }
