// radio-mapper-tpu dashboard — PURE data→fragment layer.
//
// Every function here is side-effect-free: plain data in, HTML string /
// array / plain object out. No DOM, no network, no globals, no wall
// clock (callers inject `nowMs`). The wiring layer (index.html) owns the map,
// the fetch loop and DOM mutation. This split exists so the Python
// contract test (tests/test_webapp_static.py) can statically extract
// every API field each function reads (by parameter name) and assert the
// served JSON actually carries it — both directions: JS-read ⊆ served,
// served ⊆ JS-read ∪ documented-unused.

function timeAgo(iso, nowMs) {
  const d = new Date(iso);
  if (!iso || isNaN(d)) return 'n/a';
  const s = Math.floor((nowMs - d) / 1000);
  if (s < 2) return 'just now';
  if (s < 60) return s + 's ago';
  const m = Math.floor(s / 60);
  if (m < 60) return m + 'm ago';
  const h = Math.floor(m / 60);
  if (h < 24) return h + 'h ago';
  return d.toLocaleDateString();
}

function detectionPasses(d, filter) {
  const f = d.frequency_mhz;
  if (!(f >= filter.min && f <= filter.max)) return false;
  if (filter.type !== 'all' && d.signal_type !== filter.type) return false;
  return true;
}

function signalPasses(s, filter) {
  const f = s.frequency;
  if (!(f >= filter.min && f <= filter.max)) return false;
  if (filter.type !== 'all' && s.signal_type !== filter.type) return false;
  return true;
}

// 1σ error ellipse as a [lat, lng] ring (solver CRLB; major/minor in
// meters, orientation = major-axis bearing, degrees clockwise from N).
function ellipsePoints(lat, lng, majorM, minorM, bearingDeg) {
  if (!(majorM > 0)) return null;
  const mPerDegLat = 111320, mPerDegLng = 111320 * Math.cos(lat * Math.PI / 180);
  const phi = (90 - bearingDeg) * Math.PI / 180;  // bearing -> math angle (E=0)
  const pts = [];
  for (let k = 0; k <= 36; k++) {
    const t = 2 * Math.PI * k / 36;
    const e = majorM * Math.cos(t) * Math.cos(phi) - minorM * Math.sin(t) * Math.sin(phi);
    const n = majorM * Math.cos(t) * Math.sin(phi) + minorM * Math.sin(t) * Math.cos(phi);
    pts.push([lat + n / mPerDegLat, lng + e / mPerDegLng]);
  }
  return pts;
}

function buoyPopupHtml(n, nowMs) {
  return `<b>${n.name}</b><br>status: ${n.status}<br>last seen: ${timeAgo(n.lastSeen, nowMs)}`;
}

function detectionPopupHtml(d, nowMs) {
  return `<b>${d.frequency_mhz} MHz</b><br>${d.signal_strength_dbm} dBm · conf ${d.confidence}<br>${d.node_id}<br>${timeAgo(d.timestamp, nowMs)}`;
}

function signalPopupHtml(s) {
  const ellTxt = s.ellipse_major_m > 0
    ? `<br>1σ ellipse ${Math.round(s.ellipse_major_m)}×${Math.round(s.ellipse_minor_m)} m @ ${Math.round(s.ellipse_orientation_deg)}°`
    : '';
  return `<b>${s.classification || s.signal_type}</b><br>${s.frequency} MHz · ±${Math.round(s.accuracy_meters)} m${ellTxt}<br>conf ${s.confidence.toFixed(2)}${s.method ? ' · ' + s.method : ''}<br>by ${(s.detected_by || []).join(', ')}`;
}

function signalRowHtml(s) {
  return `<div class="row ${s.signal_type === 'emergency' ? 'emergency' : ''}">
      <b>${s.frequency} MHz</b> — ${s.classification || s.signal_type}
      <div class="meta">${s.lat.toFixed(5)}, ${s.lng.toFixed(5)} · ±${Math.round(s.accuracy_meters)} m · conf ${s.confidence.toFixed(2)}${s.method ? ' · ' + s.method : ''}</div>
    </div>`;
}

function detectionRowHtml(d, nowMs) {
  return `<div class="row">
      <b>${d.frequency_mhz} MHz</b> · ${d.signal_strength_dbm} dBm
      <div class="meta">${d.node_id} · conf ${d.confidence} · ${d.signal_type} · ${timeAgo(d.timestamp, nowMs)}</div>
    </div>`;
}

function detectionTableRowHtml(d, nowMs) {
  return `
    <tr><td>${(+d.frequency_mhz).toFixed(3)} MHz</td>
        <td>${(+d.signal_strength_dbm).toFixed(1)} dBm</td>
        <td><span class="tag ${d.signal_type}">${d.signal_type}</span></td>
        <td>${d.node_id}</td>
        <td>${(+d.confidence).toFixed(2)}</td>
        <td>${timeAgo(d.timestamp, nowMs)}</td></tr>`;
}

function buoyTableRowHtml(b, nowMs) {
  return `
    <tr><td>${b.id || b.name}</td>
        <td><span class="tag ${b.status}">${(b.status || '?').toUpperCase()}</span></td>
        <td>${(+b.lat).toFixed(4)}, ${(+b.lng).toFixed(4)}</td>
        <td>${timeAgo(b.lastSeen, nowMs)}</td>
        <td>${b.latest_signal_timestamp ? timeAgo(b.latest_signal_timestamp, nowMs) : 'n/a'}</td></tr>`;
}

// null when no emergency signal is present
function emergencyBannerText(signals) {
  const emergencies = signals.filter(s => s.signal_type === 'emergency');
  if (!emergencies.length) return null;
  const e = emergencies[emergencies.length - 1];
  return `⚠ EMERGENCY SIGNAL: ${e.frequency} MHz at ` +
    `${e.lat.toFixed(5)}, ${e.lng.toFixed(5)} (±${Math.round(e.accuracy_meters)} m)`;
}

function statusModel(status) {
  return {
    ready: status.network && status.network.triangulation_ready ? 'YES' : 'NO',
    dev: !!(status.mock || status.development_mode),
  };
}

function searchResultText(res) {
  return `${res.count} match(es)` +
    (res.count ? ` — strongest at ${res.matches[0].lat.toFixed(5)}, ${res.matches[0].lng.toFixed(5)}` : '');
}
