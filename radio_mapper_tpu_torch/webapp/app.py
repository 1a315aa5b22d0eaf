"""Web dashboard server.

Capability parity with the reference webapp (`webapp/app.py`): serves the
Leaflet map UI and proxies the central processor's HTTP API so the browser
only talks to one origin (`webapp/app.py:28-37, 182-433`), with a cached
system-status endpoint. Uses aiohttp.

Port of ``radio_mapper_tpu/webapp/app.py``. ``aiohttp`` is imported only
when the app is built or started, and by the handlers, so the package
imports on a host without it. ``static/`` holds byte copies of the JAX
package's ``index.html`` and ``app.js``.

Routes:
  /                     — dashboard (Leaflet map, 5 s polling)
  /api/nodes|signals|detections|search_signal|system-status — proxied
  /api/local-status     — webapp-side status (GPS device probe, uptime)
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

from radio_mapper_tpu_torch.config.autodetect import detect_gps_devices
from radio_mapper_tpu_torch.runtime.gps import read_serial_fix

logger = logging.getLogger(__name__)

STATIC_DIR = os.path.join(os.path.dirname(__file__), "static")


class WebApp:
    def __init__(
        self,
        central_http_url: str = "http://localhost:4000",
        *,
        host: str = "0.0.0.0",
        port: int = 7000,
        hardware_cache_s: float = 10.0,
        dev_mock: bool = False,
    ):
        self.central_http_url = central_http_url.rstrip("/")
        self.host = host
        self.port = port
        self.hardware_cache_s = hardware_cache_s
        self.dev_mock = dev_mock
        self._hw_cache = (0.0, None)
        self.started_at = time.time()
        self._runner: Optional[web.AppRunner] = None

    async def _proxy(self, request: web.Request, path: str) -> web.Response:
        import aiohttp
        from aiohttp import web

        url = f"{self.central_http_url}{path}"
        try:
            async with aiohttp.ClientSession() as session:
                if request.method == "POST":
                    body = await request.read()
                    async with session.post(
                        url, data=body, headers={"Content-Type": "application/json"},
                        timeout=aiohttp.ClientTimeout(total=10),
                    ) as resp:
                        text = await resp.text()
                        return web.Response(
                            text=text, status=resp.status, content_type="application/json"
                        )
                async with session.get(
                    url, timeout=aiohttp.ClientTimeout(total=10)
                ) as resp:
                    text = await resp.text()
                    return web.Response(
                        text=text, status=resp.status, content_type="application/json"
                    )
        except (aiohttp.ClientError, TimeoutError, OSError) as e:
            logger.warning("central proxy failed for %s: %s", path, e)
            if self.dev_mock:
                # Dev-mode canned data so the UI stays demo-able without a
                # central server (`webapp/app.py:224-230, 294-317` parity).
                return web.Response(
                    text=json.dumps(self._mock_payload(path)),
                    content_type="application/json",
                )
            return web.Response(
                text=json.dumps({"error": f"central unavailable: {e}"}),
                status=502,
                content_type="application/json",
            )

    @staticmethod
    def _mock_payload(path: str):
        import time as _time
        from datetime import datetime, timezone

        now = datetime.now(timezone.utc).isoformat()
        if path == "/api/nodes":
            return [
                {"id": f"mock-buoy-{k}", "name": f"mock-buoy-{k}",
                 "lat": 35.47 + 0.05 * k, "lng": -97.55 + 0.04 * k,
                 "status": "active", "lastSeen": now,
                 "latest_signal_timestamp": now}
                for k in range(3)
            ]
        if path == "/api/detections":
            return [
                {"id": f"DET_{k}", "frequency_mhz": [105.7, 121.5, 156.8][k % 3],
                 "signal_strength_dbm": -55.0 - k, "lat": 35.46 + 0.02 * k,
                 "lng": -97.52 + 0.02 * k, "node_id": f"mock-buoy-{k % 3}",
                 "timestamp": now, "signal_type": ["testing", "emergency", "marine"][k % 3],
                 "confidence": 0.8, "triangulated": False}
                for k in range(6)
            ]
        if path == "/api/signals":
            return [{
                "id": "SIG_mock", "frequency": 121.5, "signal_strength": -50,
                "lat": 35.47, "lng": -97.51, "detected_by": ["mock-buoy-0", "mock-buoy-1", "mock-buoy-2"],
                "timestamp": now, "signal_type": "emergency",
                "classification": "Aviation Emergency - 121.5 MHz",
                "confidence": 0.9, "triangulated": True, "accuracy_meters": 45.0,
                "ellipse_major_m": 120.0, "ellipse_minor_m": 60.0,
                "ellipse_orientation_deg": 30.0,
            }]
        if path == "/api/system-status":
            return {"uptime_seconds": _time.time() % 10_000, "connected_nodes": 3,
                    "buffered_detections": 6, "triangulated_signals": 1,
                    "network": {"triangulation_ready": True}, "server_time": now,
                    "mock": True}
        return {"matches": [], "count": 0, "mock": True}

    async def index(self, request) -> web.Response:
        from aiohttp import web

        with open(os.path.join(STATIC_DIR, "index.html")) as f:
            return web.Response(text=f.read(), content_type="text/html")

    async def devices(self, request) -> web.Response:
        """`/api/devices` (`webapp/app.py:186-222` parity): buoy nodes from
        central reshaped as device records, with a human-readable last-seen
        and local hardware detection appended."""
        from datetime import datetime

        import aiohttp
        from aiohttp import web

        nodes = []
        try:
            async with aiohttp.ClientSession() as session:
                async with session.get(
                    f"{self.central_http_url}/api/nodes",
                    timeout=aiohttp.ClientTimeout(total=10),
                ) as resp:
                    nodes = await resp.json()
        except (aiohttp.ClientError, TimeoutError, OSError, ValueError):
            if self.dev_mock:
                nodes = self._mock_payload("/api/nodes")
        devices = []
        for n in nodes if isinstance(nodes, list) else []:
            last_seen = n.get("lastSeen", "")
            try:
                formatted = datetime.fromisoformat(
                    last_seen.replace("Z", "+00:00")
                ).strftime("%Y-%m-%d %H:%M:%S UTC")
            except (ValueError, AttributeError):
                formatted = last_seen
            devices.append({
                "id": n.get("id"), "name": n.get("name", n.get("id")),
                "lat": n.get("lat"), "lng": n.get("lng"),
                "status": n.get("status", "active"),
                "lastSeen": last_seen, "lastSeenFormatted": formatted,
                "type": "buoy",
            })
        return web.Response(
            text=json.dumps(devices), content_type="application/json"
        )

    async def local_status(self, request) -> web.Response:
        """Webapp-host hardware status with a 10 s cache
        (`webapp/app.py:40-57` pattern)."""
        from aiohttp import web

        now = time.time()
        ts, cached = self._hw_cache
        if cached is None or now - ts > self.hardware_cache_s:
            devices = detect_gps_devices()
            fix = None
            for dev in devices[:2]:
                fix = read_serial_fix(dev, timeout_s=0.5)
                if fix:
                    break
            cached = {
                "gps_devices": devices,
                "gps_fix": {
                    "lat": fix.lat, "lng": fix.lng, "satellites": fix.num_satellites
                } if fix else None,
                "uptime_seconds": now - self.started_at,
            }
            self._hw_cache = (now, cached)
        return web.Response(text=json.dumps(cached), content_type="application/json")

    def build_app(self) -> web.Application:
        from aiohttp import web

        app = web.Application()
        app.router.add_get("/", self.index)
        app.router.add_static("/static/", STATIC_DIR)
        app.router.add_get("/api/local-status", self.local_status)
        app.router.add_get("/api/devices", self.devices)
        def proxy_route(path):
            async def handler(request):
                return await self._proxy(request, path)

            return handler

        for path in ("/api/nodes", "/api/signals", "/api/detections", "/api/system-status"):
            app.router.add_get(path, proxy_route(path))
        app.router.add_post("/api/search_signal", proxy_route("/api/search_signal"))
        return app

    async def start(self):
        from aiohttp import web

        self._runner = web.AppRunner(self.build_app())
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        logger.info("webapp on http://%s:%d (central: %s)", self.host, self.port, self.central_http_url)

    async def stop(self):
        if self._runner:
            await self._runner.cleanup()

    async def run_forever(self):
        import asyncio

        await self.start()
        try:
            await asyncio.Future()
        finally:
            await self.stop()
