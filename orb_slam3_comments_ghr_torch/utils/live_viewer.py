"""Live observability: an HTTP viewer for a running SLAM session.

The reference's Viewer thread drives a Pangolin GL window with the current
frame overlay (FrameDrawer), the 3-D map/covisibility render (MapDrawer) and
menu toggles for localization mode / reset / follow-camera
(src/Viewer.cc:163-200). Compute hosts are headless, so the analog here is
a tiny in-process HTTP server: a browser (or curl) polls

    /            one-page UI (auto-refreshing frame + map + state)
    /state.json  tracking state, counters, fps, current pose
    /frame.png   FrameDrawer analog (utils.viz.draw_frame of the last frame)
    /map.png     MapDrawer analog (utils.viz.draw_map, top-down)
    /cmd?op=...  the Viewer menu: localization_on/localization_off/reset
                 (Viewer.cc menu buttons -> System::ActivateLocalizationMode /
                 Reset)

Rendering happens on the HTTP thread at request time from the latest
published snapshot, so the tracking loop pays only a pointer swap per frame
(`publish`). All map reads take MapState.lock for a consistent view.

Port of `orb_slam3_comments_ghr_tpu/utils/live_viewer.py`: the same page,
endpoints and JSON; the menu calls the port's `SLAM` methods.
`gba_running` is true while a whole-map BA runs on its thread (asynchronous
mapping).

Usage:
    viewer = LiveViewer(slam, port=8765); viewer.start()
    ...; viewer.publish(img)        # once per tracked frame (optional)
    viewer.stop()
"""

from __future__ import annotations

import io
import json
import threading
import time

import numpy as np

from ..pipeline.tracker import STATE_NAMES

_PAGE = b"""<!doctype html><html><head><title>orb_slam3 viewer</title>
<style>body{font-family:monospace;background:#111;color:#ddd;margin:16px}
img{image-rendering:pixelated;border:1px solid #333;margin:4px}
#state{white-space:pre}</style></head><body>
<h3>orb_slam3_comments_ghr_torch &mdash; live viewer</h3>
<div id="state">connecting...</div>
<button onclick="fetch('/cmd?op=localization_on')">localization ON</button>
<button onclick="fetch('/cmd?op=localization_off')">localization OFF</button>
<button onclick="fetch('/cmd?op=reset')">reset active map</button>
<br><img id="frame" width="752"><img id="map" width="480">
<script>
async function tick(){
  try{
    const s = await (await fetch('/state.json')).json();
    document.getElementById('state').textContent = JSON.stringify(s,null,1);
    document.getElementById('frame').src = '/frame.png?' + Date.now();
    document.getElementById('map').src = '/map.png?' + Date.now();
  }catch(e){}
  setTimeout(tick, 700);
}
tick();
</script></body></html>"""



class LiveViewer:
    def __init__(self, slam, port: int = 8765, host: str = "127.0.0.1"):
        self.slam = slam
        self.port = port
        self.host = host
        self._httpd = None
        self._thread = None
        self._last_img = None          # most recent grayscale frame (np array)
        self._last_ts = 0.0
        self._frame_count = 0
        self._t_first = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------- publish
    def publish(self, img) -> None:
        """Record the latest camera frame (cheap: one reference swap)."""
        with self._lock:
            self._last_img = np.asarray(img)
            self._last_ts = time.time()
            self._frame_count += 1
            if self._t_first is None:
                self._t_first = self._last_ts

    # -------------------------------------------------------------- server
    def start(self) -> int:
        """Start serving; returns the bound port (0 picks a free one)."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    path = self.path.split("?")[0]
                    if path == "/":
                        self._send(200, "text/html", _PAGE)
                    elif path == "/state.json":
                        self._send(200, "application/json",
                                   json.dumps(viewer._state()).encode())
                    elif path == "/frame.png":
                        self._send(200, "image/png", viewer._frame_png())
                    elif path == "/map.png":
                        self._send(200, "image/png", viewer._map_png())
                    elif path == "/cmd":
                        q = self.path.split("?", 1)[-1]
                        op = dict(
                            kv.split("=") for kv in q.split("&") if "=" in kv
                        ).get("op", "")
                        viewer._command(op)
                        self._send(200, "text/plain", b"ok")
                    else:
                        self._send(404, "text/plain", b"not found")
                except BrokenPipeError:
                    pass
                except Exception as e:  # keep serving on render errors
                    try:
                        self._send(500, "text/plain", str(e).encode())
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self.port

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    # ------------------------------------------------------------ snapshots
    def _state(self) -> dict:
        s = self.slam
        tr = s.tracker
        with self._lock:
            n = self._frame_count
            dt = (self._last_ts - self._t_first) if self._t_first else 0.0
        pose = None
        if tr.last_R is not None:
            T = np.eye(4)
            T[:3, :3] = tr.last_R
            T[:3, 3] = tr.last_t
            pose = [round(float(x), 4) for x in T[:3].reshape(-1)]
        return {
            "state": STATE_NAMES.get(int(tr.state), str(tr.state)),
            "frames_published": n,
            "fps_wall": round(n / dt, 1) if dt > 0 else 0.0,
            "keyframes": s.n_keyframes(),
            "map_points": s.n_map_points(),
            "maps": s.map.n_maps,
            "active_map": int(s.map.active_map),
            "loops": s.loopcloser.n_loops if s.loopcloser else 0,
            "merges": s.loopcloser.n_merges if s.loopcloser else 0,
            "gba_running": bool(s.loopcloser and s.loopcloser.gba_running),
            "localization_only": bool(tr.localization_only),
            "pose_Tcw_3x4": pose,
        }

    def _frame_png(self) -> bytes:
        from PIL import Image

        from . import viz

        with self._lock:
            img = self._last_img
        if img is None:
            img = np.zeros((48, 64), np.uint8)
        tr = self.slam.tracker
        feats = tr.last_feats
        arr = viz.draw_frame(
            img, feats=feats, tracked_mask=None,
            state=STATE_NAMES.get(int(tr.state), ""),
        )
        return _png_bytes(Image.fromarray(arr))

    def _map_png(self) -> bytes:
        from PIL import Image

        from . import viz

        m = self.slam.map
        with m.lock:
            arr = viz.draw_map(m, size=480)
        return _png_bytes(Image.fromarray(arr))

    # -------------------------------------------------------------- control
    def _command(self, op: str):
        """Viewer menu analog (Viewer.cc:163-200 menu handling)."""
        if op == "localization_on":
            self.slam.activate_localization_mode()
        elif op == "localization_off":
            self.slam.deactivate_localization_mode()
        elif op == "reset":
            self.slam.reset_active_map()


def _png_bytes(im) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    return buf.getvalue()
