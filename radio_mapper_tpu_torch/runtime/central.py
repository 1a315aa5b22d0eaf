"""Central processing service: WebSocket ingest + HTTP API + triangulation.

Port of ``radio_mapper_tpu/runtime/central.py`` on the port's
:class:`~radio_mapper_tpu_torch.runtime.tdoa_engine.TDoAEngine`, which
runs the snippet GCC and the LM solve on the processor's ``device`` (the
card by default):

- a websockets server with 30 s ping / 10 s timeout handling
  ``node_registration`` / ``gps_update`` / ``signal_detection`` /
  ``signal_search_response`` / ``heartbeat``;
- a 24 h in-memory signal buffer with 5-minute cleanup;
- a correlation pass on every detection, coalesced (one pass at a time):
  ≤5 s window, frequencies grouped by ``round(f, 2)``, ≥3 distinct nodes;
  the engine runs on an executor thread, under the engine's device;
- the HTTP API ``/api/nodes``, ``/api/signals``, ``/api/detections``,
  ``/api/search_signal``, ``/api/system-status`` and ``/metrics`` (aiohttp);
- ``triangulation_result`` broadcast to all connected nodes.

``aiohttp`` and ``websockets`` are imported only by :meth:`start`,
:meth:`build_http_app` and the handlers, so the correlation path runs
without them.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import time
import uuid
from collections import deque
from datetime import datetime, timedelta, timezone
from typing import TYPE_CHECKING, Dict, List, Optional

import torch

from radio_mapper_tpu_torch.constants import classification_label
from radio_mapper_tpu_torch.runtime.datamodel import (
    BuoyPosition,
    LiveSignalDetection,
    NumpyJSONEncoder,
    SignalDetection,
    TriangulatedSignal,
    parse_iso,
    utc_now_iso,
)
from radio_mapper_tpu_torch.runtime.alerts import EmergencyAlerter
from radio_mapper_tpu_torch.runtime.tdoa_engine import TDoAEngine
from radio_mapper_tpu_torch.utils.metrics import MetricsRegistry

if TYPE_CHECKING:  # the annotations only; imported where a handler runs
    from aiohttp import web

logger = logging.getLogger(__name__)

# Default node position applied when a registration omits coordinates
# (the OKC network's fallback).
DEFAULT_POSITION = (35.5513177334763, -97.53220535352492)


@dataclasses.dataclass
class NodeConnection:
    node_id: str
    websocket: object
    last_seen: datetime
    position: tuple
    status: str = "active"
    latest_signal_timestamp: Optional[datetime] = None


class CentralProcessor:
    def __init__(
        self,
        host: str = "0.0.0.0",
        ws_port: int = 8081,
        http_port: int = 4000,
        *,
        correlation_window_s: float = 5.0,
        buffer_max_age_s: float = 24 * 3600.0,
        cleanup_interval_s: float = 300.0,
        min_nodes: int = 3,
        store=None,
        stale_after_s: float = 90.0,
        alerter=None,
        waveform_mode: str = "auto",
        device: torch.device | str = "cuda",
    ):
        self.host = host
        self.ws_port = ws_port
        self.http_port = http_port
        self.correlation_window_s = correlation_window_s
        self.buffer_max_age_s = buffer_max_age_s
        self.cleanup_interval_s = cleanup_interval_s
        self.min_nodes = min_nodes
        self.stale_after_s = stale_after_s

        self.nodes: Dict[str, NodeConnection] = {}
        self.signal_buffer: List[LiveSignalDetection] = []
        # Correlation working set: only detections still inside the
        # correlation window live here, so the per-detection correlation
        # pass is O(window), not O(buffer). Entries leaving the window get
        # their IQ snippet dropped — the waveform payload is only useful
        # while correlation can still fire.
        self._recent: "deque[LiveSignalDetection]" = deque()
        self.triangulated_signals: List[TriangulatedSignal] = []
        self.engine = TDoAEngine(min_buoys=min_nodes, waveform_mode=waveform_mode, device=device)
        self.started_at = time.time()
        self.metrics = MetricsRegistry()
        self.alerter = alerter if alerter is not None else EmergencyAlerter()
        self.store = store  # optional utils.storage.SignalStore
        if store is not None:
            # Resume from persisted state.
            self.signal_buffer = store.load_detections()
            self.triangulated_signals = store.load_fixes()
            if self.signal_buffer or self.triangulated_signals:
                logger.info(
                    "Resumed %d detections, %d fixes from %s",
                    len(self.signal_buffer), len(self.triangulated_signals), store.dir,
                )

        self._ws_server = None
        self._http_runner = None
        self._cleanup_task = None
        # Correlation coalescing: at most ONE correlation pass runs at a
        # time; triggers arriving during a pass collapse into a dirty flag
        # that re-runs it once. A pass covers every detection in the
        # window, so per-pass cost is independent of how many detections
        # arrived since the last one.
        self._corr_dirty = False
        self._corr_task: Optional[asyncio.Task] = None
        # request_id → queue of node signal_search_response payloads
        self._pending_searches: Dict[str, asyncio.Queue] = {}

    # ------------------------------------------------------------------ WS

    async def handle_node_connection(self, websocket):
        import websockets

        node_id = None
        try:
            async for message in websocket:
                try:
                    data = json.loads(message)
                except json.JSONDecodeError:
                    logger.error("Invalid JSON from node: %.100s", message)
                    continue
                try:
                    node_id = await self._dispatch(websocket, node_id, data)
                except Exception:
                    logger.exception("Error processing message from node")
        except websockets.exceptions.ConnectionClosed:
            logger.info("Node %s disconnected", node_id)
        finally:
            if node_id and node_id in self.nodes:
                del self.nodes[node_id]
                logger.info("Removed disconnected node %s", node_id)

    async def _dispatch(self, websocket, node_id, data) -> Optional[str]:
        msg_type = data.get("type")
        now = datetime.now(timezone.utc)

        if msg_type == "node_registration":
            node_id = data["node_id"]
            position = (
                data.get("lat", DEFAULT_POSITION[0]),
                data.get("lng", DEFAULT_POSITION[1]),
            )
            self.nodes[node_id] = NodeConnection(
                node_id=node_id, websocket=websocket, last_seen=now, position=position
            )
            self.engine.register_buoy(
                BuoyPosition(
                    buoy_id=node_id,
                    lat=position[0],
                    lng=position[1],
                    timing_accuracy_ns=int(data.get("timing_accuracy_ns", 100_000)),
                )
            )
            logger.info("Node %s registered at %s", node_id, position)
            await websocket.send(
                json.dumps(
                    {
                        "type": "registration_ack",
                        "status": "registered",
                        "server_time": utc_now_iso(),
                    }
                )
            )

        elif msg_type == "gps_update":
            nid = data.get("node_id")
            lat, lng = data.get("lat"), data.get("lng")
            if nid and lat is not None and lng is not None:
                if nid in self.nodes:
                    self.nodes[nid].position = (lat, lng)
                self.engine.register_buoy(
                    BuoyPosition(
                        buoy_id=nid,
                        lat=lat,
                        lng=lng,
                        timing_accuracy_ns=int(data.get("timing_accuracy_ns", 100_000)),
                    )
                )
            else:
                logger.warning("Invalid GPS update: %s", data)

        elif msg_type == "signal_detection":
            detection = LiveSignalDetection.from_message(data["data"])
            if detection.node_id in self.nodes:
                node = self.nodes[detection.node_id]
                node.last_seen = now
                try:
                    node.latest_signal_timestamp = parse_iso(detection.timestamp_utc)
                except (ValueError, TypeError):
                    pass
            self.signal_buffer.append(detection)
            self._recent.append(detection)
            self.metrics.inc("detections_received")
            if self.store is not None:
                self.store.append_detection(detection)
            logger.info(
                "Signal from %s: %.3f MHz, %.1f dBm",
                detection.node_id,
                detection.frequency_mhz,
                detection.signal_strength_dbm,
            )
            self._schedule_correlations()

        elif msg_type == "signal_search_response":
            rid = data.get("request_id")
            q = self._pending_searches.get(rid)
            if q is not None:
                q.put_nowait(data)

        elif msg_type == "heartbeat":
            hb_id = data.get("node_id") or node_id
            if hb_id and hb_id in self.nodes:
                self.nodes[hb_id].last_seen = now
                node_id = hb_id
            await websocket.send(
                json.dumps({"type": "heartbeat_ack", "server_time": utc_now_iso()})
            )

        return node_id

    # ------------------------------------------------------- correlation

    def _schedule_correlations(self):
        """Trigger a correlation pass, coalescing concurrent triggers."""
        self._corr_dirty = True
        if self._corr_task is None or self._corr_task.done():
            # Callers are always inside the running server loop;
            # get_event_loop() from sync context is deprecated (ADVICE r3).
            self._corr_task = asyncio.get_running_loop().create_task(
                self._correlation_worker()
            )

    async def _correlation_worker(self):
        while self._corr_dirty:
            self._corr_dirty = False
            try:
                await self.process_signal_correlations()
            except Exception:  # pragma: no cover - defensive
                logger.exception("correlation pass failed")

    async def process_signal_correlations(self):
        """≤window recent signals, grouped by round(f, 2), ≥min_nodes distinct
        nodes → triangulate on an executor thread (:meth:`_run_engine`)."""
        now_ts = datetime.now(timezone.utc).timestamp()
        # Age the working set: pop detections that left the correlation
        # window and release their IQ snippets (they stay in signal_buffer
        # for the HTTP APIs, snippet-free).
        while self._recent:
            det = self._recent[0]
            try:
                ts = parse_iso(det.timestamp_utc).timestamp()
            except (ValueError, TypeError):
                self._recent.popleft()
                continue
            if now_ts - ts <= self.correlation_window_s:
                break
            det.iq_samples = None
            self._recent.popleft()

        groups: Dict[float, List[LiveSignalDetection]] = {}
        for det in self._recent:
            groups.setdefault(round(det.frequency_mhz, 2), []).append(det)

        for freq, dets in groups.items():
            if len({d.node_id for d in dets}) < self.min_nodes:
                continue
            detections = [
                SignalDetection(
                    buoy_id=d.node_id,
                    frequency_mhz=d.frequency_mhz,
                    signal_strength_dbm=d.signal_strength_dbm,
                    timestamp_utc=d.timestamp_utc,
                    gps_timestamp_ns=d.gps_timestamp_ns,
                    lat=d.lat,
                    lng=d.lng,
                    confidence=d.confidence,
                    signal_type=d.signal_type,
                    # IQ snippets ride through to the engine's waveform
                    # GCC-PHAT mode.
                    iq_samples=d.iq_samples,
                    iq_sample_rate_hz=d.iq_sample_rate_hz,
                    iq_anchor_ns=d.iq_anchor_ns,
                )
                for d in dets
            ]
            with self.metrics.timer("triangulation").time():
                results = await asyncio.get_running_loop().run_in_executor(
                    None, self._run_engine, detections
                )
            for r in results:
                signal = TriangulatedSignal(
                    signal_id=f"SIG_{uuid.uuid4().hex[:8]}",
                    frequency_mhz=r.frequency_mhz,
                    estimated_lat=r.estimated_lat,
                    estimated_lng=r.estimated_lng,
                    confidence=r.confidence,
                    detected_by=r.contributing_buoys,
                    detection_timestamps=[d.timestamp_utc for d in dets],
                    signal_type=r.signal_type,
                    triangulation_method=r.method,
                    accuracy_meters=r.accuracy_meters,
                    ellipse_major_m=r.ellipse_major_m,
                    ellipse_minor_m=r.ellipse_minor_m,
                    ellipse_orientation_deg=r.ellipse_orientation_deg,
                )
                self.triangulated_signals.append(signal)
                self.metrics.inc("fixes_computed")
                self.metrics.inc(f"fixes_{r.method.replace('+', '_').replace('-', '_')}")
                # Detection→fix latency: wall time since the newest
                # contributing detection was stamped at its buoy.
                try:
                    newest = max(
                        parse_iso(d.timestamp_utc).timestamp() for d in dets
                    )
                    self.metrics.timer("fix_latency").observe(
                        max(0.0, datetime.now(timezone.utc).timestamp() - newest)
                    )
                except (ValueError, TypeError):
                    pass
                if self.alerter.process(signal):
                    self.metrics.inc("emergency_alerts")
                if self.store is not None:
                    self.store.append_fix(signal)
                logger.info(
                    "Triangulated %.3f MHz at (%.6f, %.6f) ±%.1fm",
                    freq, r.estimated_lat, r.estimated_lng, r.accuracy_meters,
                )
                await self.broadcast_triangulation(signal)

    def _run_engine(self, detections: List[SignalDetection]):
        """The engine's pass over one group, on the calling (executor)
        thread: a CUDA engine's device is made that thread's current one,
        so every launch of the pass goes to the engine's card."""
        dev = self.engine.device
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                return self.engine.process_signal_detections(detections)
        return self.engine.process_signal_detections(detections)

    async def broadcast_triangulation(self, signal: TriangulatedSignal):
        """Send the fix back to every node."""
        payload = json.dumps(
            {"type": "triangulation_result", "data": dataclasses.asdict(signal)},
            cls=NumpyJSONEncoder,
        )
        for node in list(self.nodes.values()):
            try:
                await node.websocket.send(payload)
            except Exception:
                pass

    # ------------------------------------------------------------- HTTP

    def _json(self, obj, status: int = 200) -> web.Response:
        from aiohttp import web

        return web.Response(
            text=json.dumps(obj, cls=NumpyJSONEncoder),
            status=status,
            content_type="application/json",
        )

    def _refresh_node_status(self):
        """Heartbeat-based liveness: nodes silent past the threshold are
        marked stale."""
        now = datetime.now(timezone.utc)
        for node in self.nodes.values():
            silent = (now - node.last_seen).total_seconds()
            node.status = "active" if silent < self.stale_after_s else "stale"

    async def api_nodes(self, request) -> web.Response:
        """``/api/nodes``."""
        self._refresh_node_status()
        node_list = []
        for node_id, node in self.nodes.items():
            lat, lng = node.position
            for det in reversed(self.signal_buffer[-50:]):
                if det.node_id == node_id:
                    lat, lng = det.lat, det.lng
                    break
            node_list.append(
                {
                    "id": node_id,
                    "name": node_id,
                    "lat": lat,
                    "lng": lng,
                    "status": node.status,
                    "lastSeen": node.last_seen.isoformat(),
                    "latest_signal_timestamp": node.latest_signal_timestamp.isoformat()
                    if node.latest_signal_timestamp
                    else None,
                }
            )
        return self._json(node_list)

    async def api_signals(self, request) -> web.Response:
        """``/api/signals``."""
        out = []
        for s in self.triangulated_signals[-50:]:
            out.append(
                {
                    "id": s.signal_id,
                    "frequency": s.frequency_mhz,
                    "signal_strength": -50,
                    "lat": s.estimated_lat,
                    "lng": s.estimated_lng,
                    "detected_by": s.detected_by,
                    "timestamp": s.detection_timestamps[0]
                    if s.detection_timestamps
                    else None,
                    "signal_type": s.signal_type,
                    "classification": classification_label(s.frequency_mhz, s.signal_type),
                    "confidence": s.confidence,
                    "triangulated": True,
                    "accuracy_meters": s.accuracy_meters,
                    # extensions over the reference shape: how the fix was
                    # solved ("gcc-phat+lm" waveform vs "hyperbolic-lm"
                    # timestamp differencing) and the 1σ CRLB error ellipse
                    "method": s.triangulation_method,
                    "ellipse_major_m": s.ellipse_major_m,
                    "ellipse_minor_m": s.ellipse_minor_m,
                    "ellipse_orientation_deg": s.ellipse_orientation_deg,
                }
            )
        return self._json(out)

    async def api_detections(self, request) -> web.Response:
        """``/api/detections``: last 10 min, ≤20 per frequency."""
        cutoff = datetime.now(timezone.utc) - timedelta(minutes=10)
        freq_groups: Dict[float, List[LiveSignalDetection]] = {}
        for det in reversed(self.signal_buffer):
            try:
                if parse_iso(det.timestamp_utc) < cutoff:
                    continue
            except (ValueError, TypeError):
                continue
            group = freq_groups.setdefault(det.frequency_mhz, [])
            if len(group) < 20:
                group.append(det)
        recent = [d for group in freq_groups.values() for d in group]
        recent.sort(key=lambda d: d.timestamp_utc, reverse=True)
        return self._json(
            [
                {
                    "id": f"DET_{i}",
                    "frequency_mhz": d.frequency_mhz,
                    "signal_strength_dbm": d.signal_strength_dbm,
                    "lat": d.lat,
                    "lng": d.lng,
                    "node_id": d.node_id,
                    "timestamp": d.timestamp_utc,
                    "signal_type": d.signal_type,
                    "confidence": d.confidence,
                    "triangulated": False,
                }
                for i, d in enumerate(recent)
            ]
        )

    async def distributed_signal_search(
        self, payload: dict, *, timeout_s: float = 5.0
    ) -> list:
        """Fan a `signal_search_request` out to every connected node and
        aggregate their match lists (tagged with the responding node).

        This is the service plane for the waveform/metadata history search
        buoys answer locally; responses arriving after ``timeout_s`` are
        dropped (nodes are remote and may be gone).
        """
        rid = uuid.uuid4().hex
        queue: asyncio.Queue = asyncio.Queue()
        self._pending_searches[rid] = queue
        msg = json.dumps(
            {"type": "signal_search_request", "data": {**payload, "request_id": rid}},
            cls=NumpyJSONEncoder,
        )
        queried = 0
        for node in list(self.nodes.values()):
            try:
                await node.websocket.send(msg)
                queried += 1
            except Exception:
                logger.warning("search fan-out to %s failed", node.node_id)
        matches: list = []
        try:
            deadline = asyncio.get_running_loop().time() + timeout_s
            for _ in range(queried):
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    break
                resp = await asyncio.wait_for(queue.get(), timeout=remaining)
                nid = resp.get("node_id")
                for m in resp.get("matches", []):
                    matches.append({**m, "node_id": nid})
        except asyncio.TimeoutError:
            pass
        finally:
            del self._pending_searches[rid]
        matches.sort(key=lambda m: -m.get("match_score", m.get("confidence", 0.0)))
        return matches

    async def api_search_signal(self, request) -> web.Response:
        """POST ``/api/search_signal``.

        With an ``iq_pattern`` field ([re, im] pairs) the search fans out
        to the live nodes as a waveform match instead of scanning the
        central fix buffer.
        """
        try:
            data = await request.json()
        except json.JSONDecodeError:
            return self._json({"error": "invalid JSON"}, status=400)
        if data.get("iq_pattern"):
            payload = {
                k: data[k]
                for k in (
                    "iq_pattern", "min_score", "frequency_mhz",
                    "frequency_range_mhz", "max_age_minutes",
                )
                if k in data
            }
            matches = await self.distributed_signal_search(
                payload, timeout_s=float(data.get("timeout_s", 5.0))
            )
            return self._json(
                {"matches": matches, "count": len(matches),
                 "nodes_queried": len(self.nodes)}
            )
        frequency = data.get("frequency_mhz")
        if frequency is None:
            return self._json({"error": "frequency_mhz required"}, status=400)
        max_age_minutes = data.get("max_age_minutes", 60)
        cutoff = datetime.now(timezone.utc).timestamp() - max_age_minutes * 60
        matches = []
        for s in self.triangulated_signals:
            if not s.detection_timestamps:
                continue
            try:
                ts = parse_iso(s.detection_timestamps[0]).timestamp()
            except (ValueError, TypeError):
                continue
            if ts < cutoff:
                continue
            if abs(s.frequency_mhz - frequency) < 0.01:
                matches.append(
                    {
                        "frequency_mhz": s.frequency_mhz,
                        "lat": s.estimated_lat,
                        "lng": s.estimated_lng,
                        "confidence": s.confidence,
                        "detected_by": s.detected_by,
                        "timestamp": s.detection_timestamps[0],
                        "accuracy_meters": s.accuracy_meters,
                        "ellipse_major_m": s.ellipse_major_m,
                        "ellipse_minor_m": s.ellipse_minor_m,
                        "ellipse_orientation_deg": s.ellipse_orientation_deg,
                    }
                )
        return self._json({"matches": matches, "count": len(matches)})

    async def api_system_status(self, request) -> web.Response:
        """``/api/system-status``."""
        return self._json(
            {
                "uptime_seconds": time.time() - self.started_at,
                "connected_nodes": len(self.nodes),
                "buffered_detections": len(self.signal_buffer),
                "triangulated_signals": len(self.triangulated_signals),
                "network": self.engine.get_network_status(),
                "server_time": utc_now_iso(),
            }
        )

    async def api_metrics(self, request) -> web.Response:
        from aiohttp import web

        self.metrics.set_gauge("connected_nodes", len(self.nodes))
        self.metrics.set_gauge("buffered_detections", len(self.signal_buffer))
        self.metrics.set_gauge("uptime_seconds", time.time() - self.started_at)
        return web.Response(
            text=self.metrics.render_prometheus(), content_type="text/plain"
        )

    async def api_index(self, request) -> web.Response:
        from aiohttp import web

        return web.Response(text="radio-mapper-tpu central processor")

    def build_http_app(self) -> web.Application:
        from aiohttp import web

        app = web.Application()
        app.router.add_get("/", self.api_index)
        app.router.add_get("/api/nodes", self.api_nodes)
        app.router.add_get("/api/signals", self.api_signals)
        app.router.add_get("/api/detections", self.api_detections)
        app.router.add_post("/api/search_signal", self.api_search_signal)
        app.router.add_get("/api/system-status", self.api_system_status)
        app.router.add_get("/metrics", self.api_metrics)
        return app

    # ------------------------------------------------------------ lifecycle

    async def _cleanup_loop(self):
        """Periodic 24 h buffer cleanup."""
        while True:
            await asyncio.sleep(self.cleanup_interval_s)
            cutoff = datetime.now(timezone.utc).timestamp() - self.buffer_max_age_s
            kept = []
            for det in self.signal_buffer:
                try:
                    if parse_iso(det.timestamp_utc).timestamp() >= cutoff:
                        kept.append(det)
                except (ValueError, TypeError):
                    continue
            dropped = len(self.signal_buffer) - len(kept)
            if dropped:
                logger.info("Buffer cleanup: dropped %d aged detections", dropped)
            self.signal_buffer[:] = kept

    async def start(self):
        import websockets
        from aiohttp import web

        self._ws_server = await websockets.serve(
            self.handle_node_connection,
            self.host,
            self.ws_port,
            ping_interval=30,
            ping_timeout=10,
        )
        self._http_runner = web.AppRunner(self.build_http_app())
        await self._http_runner.setup()
        site = web.TCPSite(self._http_runner, self.host, self.http_port)
        await site.start()
        self._cleanup_task = asyncio.create_task(self._cleanup_loop())
        logger.info(
            "Central processor up: ws://%s:%d, http://%s:%d",
            self.host, self.ws_port, self.host, self.http_port,
        )

    async def stop(self):
        if self._cleanup_task:
            self._cleanup_task.cancel()
        if self._corr_task and not self._corr_task.done():
            self._corr_task.cancel()
        if self._ws_server:
            self._ws_server.close()
            await self._ws_server.wait_closed()
        if self._http_runner:
            await self._http_runner.cleanup()

    async def run_forever(self):
        await self.start()
        try:
            await asyncio.Future()
        finally:
            await self.stop()
