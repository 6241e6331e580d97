"""Browser-attached live GUI.

The reference embeds an OpenGL LV2UI in the DAW (gui/phaserotate.c:
1136-1309: custom dials, gradient meters, link checkbox, click-to-reset
peaks).  A GPU engine lives behind a daemon, so the framework's graphical
surface is served over HTTP instead of embedded: the SAME widget models
(gui/widgets.py), deflection maps (gui/deflect.py), and SVG renderers
(gui/render.py meter_svg/faceplate_svg) drive a browser page attached to
the live engine — dial drags write the angle control path, meters stream
the real 'levels' protocol (plugin/protocol.py LevelsMsg), link mirrors
dial 0 to dial 1, clicking a meter sends reset_peaks.

Two mounts:

* ``phase-rotate-host --web PORT`` — the standalone host serves its own
  plugin instance (the robtk JACK-wrapper equivalent with a browser
  window instead of pugl).
* ``phaserotate-bridge --ui-port PORT`` — the engine daemon serves every
  live client session (LV2 shim / prt_bridge connections), so a DAW user
  gets the full graphical surface for the plugin the DAW loaded; the
  LV2UI stub (native/prt_ui.cc) referenced from the bundle manifest
  points the host at this page.

The server is stdlib-only (ThreadingHTTPServer); surfaces are duck-typed
(see :class:`HostSurface` for the contract) so the daemon provides its
own session-backed implementation in bridge.py.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from .render import faceplate_svg, meter_svg

__all__ = ["WebUI", "HostSurface", "DEFAULT_UI_PORT"]

DEFAULT_UI_PORT = 8626


class HostSurface:
    """WebUI surface over an in-process StandaloneHost.

    This class documents the surface contract (the daemon's session
    surface in bridge.py implements the same methods):

    * ``label`` / ``channels`` attributes
    * ``snapshot() -> dict`` — angles, link, ui_scale, meters
    * ``set_dial(chn, degrees)`` / ``scroll_dial(chn, steps)``
    * ``set_link(active)`` / ``reset_peaks()`` / ``set_scale(s)``
    """

    def __init__(self, host, label: str = "standalone"):
        self.host = host
        self.label = label
        self.channels = host.plugin.n_chn
        if not host.ui._open:
            host.ui.open()  # ui_on handshake -> plugin forges levels

    def snapshot(self) -> dict:
        ui = self.host.ui
        ui.poll()
        return {
            "label": self.label,
            "channels": self.channels,
            "rate": int(self.host.plugin.rate),
            "link": ui.link.active,
            "ui_scale": ui.ui_scale,
            "angles": [d.value for d in ui.dials],
            "meters": [vars(m).copy() for m in ui.meters],
        }

    def set_dial(self, chn: int, degrees: float) -> None:
        self.host.ui.dials[chn].set_value(float(degrees))

    def scroll_dial(self, chn: int, steps: int) -> None:
        self.host.ui.dials[chn].scroll(int(steps))

    def set_link(self, active: bool) -> None:
        self.host.ui.set_link(bool(active))

    def reset_peaks(self) -> None:
        self.host.ui.click_meter()

    def set_scale(self, scale: float) -> None:
        self.host.ui.set_scale(float(scale))


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>phaserotate</title>
<style>
 body { background:#1a1a1a; color:#ddd; font:13px sans-serif; margin:16px }
 .session { border:1px solid #333; border-radius:6px; padding:10px;
            margin-bottom:14px; max-width:640px }
 .chrow { display:flex; align-items:center; gap:14px; margin:6px 0 }
 .dial  { cursor:ns-resize; user-select:none; touch-action:none }
 .meters { cursor:pointer }
 .hdr { color:#8ac; margin-bottom:4px }
 label { color:#aaa }
 .offline { color:#a66 }
</style></head><body>
<h3>Phase Rotate (GPU)</h3>
<div id="sessions"><i>connecting&hellip;</i></div>
<script>
const S = document.getElementById('sessions');
let dragging = null;   // {sid, chn, y0, a0}

function render(state) {
  const sids = Object.keys(state.sessions);
  if (!sids.length) {
    S.innerHTML = '<i class="offline">no live engine sessions</i>';
    return;
  }
  let html = '';
  for (const sid of sids) {
    const s = state.sessions[sid];
    html += `<div class="session"><div class="hdr">${s.label} &mdash; ` +
            `${s.rate} Hz, ${s.channels} ch</div>`;
    for (let c = 0; c < s.channels; c++) {
      html += `<div class="chrow">` +
        `<div class="dial" data-sid="${sid}" data-chn="${c}" ` +
        `data-angle="${s.angles[c]}">${s.dial_svg[c]}</div>` +
        `<div class="meters" data-sid="${sid}">${s.meter_svg[c]}</div>` +
        `</div>`;
    }
    if (s.channels > 1) {
      html += `<label><input type="checkbox" data-sid="${sid}" ` +
        `class="link" ${s.link ? 'checked' : ''}> link channels</label>`;
    }
    html += '</div>';
  }
  S.innerHTML = html;
}

async function post(body) {
  await fetch('/control', {method: 'POST', body: JSON.stringify(body)});
}

S.addEventListener('pointerdown', e => {
  const d = e.target.closest('.dial');
  if (!d) return;
  dragging = {sid: d.dataset.sid, chn: +d.dataset.chn,
              y0: e.clientY, a0: +d.dataset.angle};
  d.setPointerCapture(e.pointerId);
});
S.addEventListener('pointermove', e => {
  if (!dragging) return;
  const delta = (dragging.y0 - e.clientY) * 0.5;  // 0.5 deg per px
  post({action: 'dial', session: dragging.sid, channel: dragging.chn,
        value: dragging.a0 + delta});
});
S.addEventListener('pointerup', () => { dragging = null; });
S.addEventListener('dblclick', e => {
  const d = e.target.closest('.dial');
  if (d) post({action: 'dial', session: d.dataset.sid,
               channel: +d.dataset.chn, value: 0});
});
S.addEventListener('wheel', e => {
  const d = e.target.closest('.dial');
  if (!d) return;
  e.preventDefault();
  post({action: 'scroll', session: d.dataset.sid,
        channel: +d.dataset.chn, steps: e.deltaY < 0 ? 1 : -1});
}, {passive: false});
S.addEventListener('click', e => {
  const m = e.target.closest('.meters');
  if (m) post({action: 'reset', session: m.dataset.sid});
  const l = e.target.closest('.link');
  if (l) post({action: 'link', session: l.dataset.sid,
               active: l.checked});
});

async function tick() {
  try {
    const r = await fetch('/state');
    if (!dragging) render(await r.json());
  } catch (err) { /* daemon restarting */ }
  setTimeout(tick, 50);
}
tick();
</script></body></html>
"""


class _MeterShim:
    """Adapts a plain meter dict to the attribute access meter_svg
    expects (gui.client.MeterValues fields)."""

    def __init__(self, d: dict):
        self.__dict__.update(d)


class WebUI:
    """HTTP server publishing live surfaces.

    ``registry`` is a callable returning ``{sid: surface}`` — evaluated
    per request so daemon sessions appear/disappear live.
    """

    def __init__(self, registry: Callable[[], Dict[str, object]],
                 port: int = 0, host: str = "127.0.0.1"):
        self._registry = registry
        self._addr = (host, port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        assert self._httpd is not None, "not started"
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._addr[0]}:{self.port}/"

    def start(self) -> "WebUI":
        registry = self._registry

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._send(200, _PAGE.encode(),
                               "text/html; charset=utf-8")
                    return
                if self.path == "/state":
                    sessions = {}
                    for sid, surf in registry().items():
                        try:
                            snap = surf.snapshot()
                        except Exception:
                            continue  # session died mid-request
                        snap["dial_svg"] = [
                            faceplate_svg(angle=a)
                            for a in snap["angles"]]
                        snap["meter_svg"] = [
                            meter_svg(_MeterShim(m))
                            for m in snap["meters"]]
                        sessions[sid] = snap
                    self._send(200, json.dumps(
                        {"sessions": sessions}).encode())
                    return
                self._send(404, b'{"error": "not found"}')

            def do_POST(self):
                if self.path != "/control":
                    self._send(404, b'{"error": "not found"}')
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if not 0 <= n <= 65536:
                        # control messages are tiny; a hostile
                        # Content-Length must not drive a huge read
                        self._send(400, b'{"error": "body too large"}')
                        return
                    msg = json.loads(self.rfile.read(n) or b"{}")
                    surf = registry()[str(msg["session"])]
                    action = msg["action"]
                    if action == "dial":
                        surf.set_dial(int(msg["channel"]),
                                      float(msg["value"]))
                    elif action == "scroll":
                        surf.scroll_dial(int(msg["channel"]),
                                         int(msg["steps"]))
                    elif action == "link":
                        surf.set_link(bool(msg["active"]))
                    elif action == "reset":
                        surf.reset_peaks()
                    elif action == "scale":
                        surf.set_scale(float(msg["value"]))
                    else:
                        self._send(400, b'{"error": "unknown action"}')
                        return
                except (KeyError, IndexError, ValueError,
                        TypeError) as e:
                    self._send(400, json.dumps(
                        {"error": str(e)}).encode())
                    return
                self._send(200, b'{"ok": true}')

        self._httpd = ThreadingHTTPServer(self._addr, Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
