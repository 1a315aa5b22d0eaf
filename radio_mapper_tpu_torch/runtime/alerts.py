"""Emergency alerting with repeat suppression.

A copy of ``radio_mapper_tpu/runtime/alerts.py`` on the port's datamodel
(importing the reference's module would load JAX through its package
``__init__``): automatic alerts on emergency-band triangulations above a
confidence threshold, routed to console/log (webhook optional, through a
lazily imported ``requests``), with a per-frequency repeat-suppression
window (``repeat_alert_minutes``).
"""

from __future__ import annotations

import json
import logging
import time
from typing import Callable, Dict, List, Optional

from radio_mapper_tpu_torch.runtime.datamodel import TriangulatedSignal

logger = logging.getLogger(__name__)


class EmergencyAlerter:
    def __init__(
        self,
        *,
        auto_alert: bool = True,
        methods: Optional[List[str]] = None,
        confidence_threshold: float = 0.8,
        repeat_alert_minutes: float = 5.0,
        webhook_url: Optional[str] = None,
        webhook_post: Optional[Callable[[str, dict], None]] = None,
    ):
        self.auto_alert = auto_alert
        self.methods = methods if methods is not None else ["console", "log"]
        self.confidence_threshold = confidence_threshold
        self.repeat_window_s = repeat_alert_minutes * 60.0
        self.webhook_url = webhook_url
        self._webhook_post = webhook_post or self._default_webhook_post
        self._last_alert: Dict[float, float] = {}  # freq (rounded) → ts
        self.alerts_sent = 0

    @staticmethod
    def _default_webhook_post(url: str, payload: dict) -> None:  # pragma: no cover
        import requests

        requests.post(url, json=payload, timeout=5)

    def should_alert(self, signal: TriangulatedSignal, now: Optional[float] = None) -> bool:
        if not self.auto_alert or signal.signal_type not in (
            "emergency",
            "emergency_beacon",
        ):
            return False
        if signal.confidence < self.confidence_threshold:
            return False
        now = time.time() if now is None else now
        key = round(signal.frequency_mhz, 2)
        last = self._last_alert.get(key)
        if last is not None and now - last < self.repeat_window_s:
            return False
        return True

    def process(self, signal: TriangulatedSignal, now: Optional[float] = None) -> bool:
        """Alert if warranted; returns True when an alert fired."""
        if not self.should_alert(signal, now):
            return False
        now = time.time() if now is None else now
        self._last_alert[round(signal.frequency_mhz, 2)] = now
        self.alerts_sent += 1
        message = (
            f"EMERGENCY: {signal.frequency_mhz:.3f} MHz at "
            f"({signal.estimated_lat:.5f}, {signal.estimated_lng:.5f}) "
            f"±{signal.accuracy_meters:.0f} m, confidence {signal.confidence:.2f}, "
            f"seen by {', '.join(signal.detected_by)}"
        )
        if "console" in self.methods:
            print(f"\033[91m⚠ {message}\033[0m", flush=True)
        if "log" in self.methods:
            logger.warning("%s", message)
        if "webhook" in self.methods and self.webhook_url:
            try:
                self._webhook_post(
                    self.webhook_url,
                    {"type": "emergency_alert", "message": message,
                     "signal": json.loads(json.dumps(signal.__dict__, default=str))},
                )
            except Exception:
                logger.exception("webhook alert failed")
        return True
