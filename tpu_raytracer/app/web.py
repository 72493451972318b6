"""Browser live viewer — a real WINDOWED display with MOUSE input.

The reference scaffolds (and disables) a cv::imshow window with
mouse-orbit and WASD fly controls (kernel.cu:262-263, 113-139,
51-104). A headless render host has no X display, so the window here
is a browser tab served straight from the render host over plain stdlib
``http.server`` — no OpenCV GUI, no extra dependencies:

  * dragging the image orbits the camera with the reference's exact
    sensitivity (yaw += dx * 0.001, pitch -= dy * 0.001;
    kernel.cu:131-132 — via app.controls.orbit, shared with the
    terminal viewer);
  * W/A/S/D (+ Q/E down/up) fly along the pose-relative axes
    (kernel.cu:51-104's invert_lre + apply_lre forward walk);
  * the <img> tag long-polls ``/frame.png`` — every request renders
    one frame at the CURRENT pose through the jitted pipeline. Pose is
    a runtime argument (Camera.cu:29-31 analog), so input never
    recompiles; steady-state cost is one render per displayed frame.

Usage::

    from tpu_raytracer.app.web import WebViewer
    WebViewer(arrays, cam, config).serve()   # http://host:8000/

The CPU test suite drives the full HTTP surface headlessly
(tests/test_web.py): page, frame fetch, drag + key events, pose
mutation observable as changed pixels.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..render import RenderConfig
from ..render.pipeline import render_image
from ..utils.image import encode_png
from .controls import fly, orbit

_PAGE = """<!doctype html>
<title>tpu-raytracer</title>
<style>body{margin:0;background:#111;display:grid;place-items:center;
height:100vh}img{image-rendering:pixelated;cursor:grab}
#hud{position:fixed;top:8px;left:8px;color:#7f7;font:12px monospace}
</style>
<div id="hud">drag: orbit &nbsp; wasd/qe: fly</div>
<img id="v" width="%WIDTH%" height="%HEIGHT%">
<script>
const v = document.getElementById('v');
let busy = false;
function refresh() {
  if (busy) return; busy = true;
  const img = new Image();
  img.onload = () => { v.src = img.src; busy = false; requestAnimationFrame(refresh); };
  img.onerror = () => { busy = false; setTimeout(refresh, 500); };
  img.src = '/frame.png?' + Date.now();
}
refresh();
let drag = null;
v.addEventListener('pointerdown', e => { drag = [e.clientX, e.clientY]; v.setPointerCapture(e.pointerId); });
v.addEventListener('pointerup', () => drag = null);
v.addEventListener('pointermove', e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY];
  fetch('/drag?dx=' + dx + '&dy=' + dy, {method: 'POST'});
});
window.addEventListener('keydown', e => {
  if ('wasdqe'.includes(e.key)) fetch('/key?k=' + e.key, {method: 'POST'});
});
</script>"""


class WebViewer:
    """Serve a live, interactive render of ``scene`` at ``camera``'s
    starting pose. Thread-safe pose state; one render per frame
    request (the browser self-paces by re-requesting on load).

    ``mode`` selects the integrator like the driver loop: primary |
    whitted | path | ao. Path mode renders PROGRESSIVELY (same scheme
    as the terminal viewer, app/interactive.py): each frame adds
    ``path_samples`` fresh samples to an on-device linear-radiance
    accumulator that resets when the camera moves — hold still and the
    image converges; only the tonemapped u8 preview leaves the device."""

    def __init__(self, scene, camera, config: RenderConfig | None = None,
                 move_step: float = 0.15, mode: str = "primary",
                 path_samples: int = 2, path_bounces: int = 3,
                 ao_radius: float = 1.0):
        if mode not in ("primary", "whitted", "path", "ao"):
            raise ValueError(f"unknown mode {mode!r}")
        self.scene = scene
        self.camera = camera
        self.config = config or RenderConfig(
            width=camera.width, height=camera.height,
        )
        self.move_step = float(move_step)
        self.mode = mode
        self.path_samples = int(path_samples)
        self.path_bounces = int(path_bounces)
        self.ao_radius = float(ao_radius)
        self._lock = threading.Lock()
        # serialize renders: ThreadingHTTPServer handles requests on
        # threads; one render at a time keeps one device's work in
        # order and the pose/accumulator state consistent
        self._render_lock = threading.Lock()
        self._pose = np.array(camera.pose, np.float32)
        self._pose_version = 0
        p = camera.ray_params()
        self._K_inv, self._D = p["K_inv"], p["D"]
        self.frames_rendered = 0
        self._accum = None       # path mode: device radiance sum
        self._accum_n = 0        # samples accumulated
        self._accum_version = -1  # pose version the sum belongs to

    # -- input (the kernel.cu mouse/WASD semantics) --------------------
    def on_drag(self, dx: float, dy: float) -> None:
        with self._lock:
            self._pose = orbit(self._pose, dx, dy)
            self._pose_version += 1

    def on_key(self, k: str) -> None:
        step = self.move_step
        move = {
            "w": dict(forward=step), "s": dict(forward=-step),
            "a": dict(right=-step), "d": dict(right=step),
            "q": dict(up=-step), "e": dict(up=step),
        }.get(k)
        if move:
            with self._lock:
                self._pose = fly(self._pose, **move)
                self._pose_version += 1

    def pose(self) -> np.ndarray:
        with self._lock:
            return self._pose.copy()

    def _pose_state(self):
        with self._lock:
            return self._pose.copy(), self._pose_version

    # -- rendering ------------------------------------------------------
    def render_frame(self) -> bytes:
        from ..core import transforms as T

        pose, version = self._pose_state()
        inv_pose = np.asarray(T.invert_lre(pose))
        with self._render_lock:
            args = (self.config, self.scene, self._K_inv, self._D,
                    pose, inv_pose)
            if self.mode == "whitted":
                from ..render.pipeline import render_image_whitted

                img = render_image_whitted(*args)
            elif self.mode == "path":
                import jax

                from ..render.integrators import to_u8, tonemap
                from ..render.pipeline import render_radiance_path_traced

                key = jax.random.fold_in(
                    jax.random.PRNGKey(0), self.frames_rendered
                )
                rad = render_radiance_path_traced(
                    *args, key, self.path_bounces, self.path_samples,
                )
                if self._accum is None or self._accum_version != version:
                    self._accum, self._accum_n = rad, 1
                    self._accum_version = version
                else:
                    self._accum = self._accum + rad
                    self._accum_n += 1
                img = to_u8(tonemap(
                    self._accum / self._accum_n,
                    self.config.tonemap, self.config.exposure,
                ))
            elif self.mode == "ao":
                import jax

                from ..render.pipeline import render_image_ao

                key = jax.random.fold_in(
                    jax.random.PRNGKey(0), self.frames_rendered
                )
                img = render_image_ao(*args, key, 8, self.ao_radius)
            else:
                img = render_image(*args)
            img = np.asarray(img)
            self.frames_rendered += 1
        return encode_png(img)

    # -- server ----------------------------------------------------------
    def make_server(self, host: str = "127.0.0.1", port: int = 8000
                    ) -> ThreadingHTTPServer:
        viewer = self
        page = (_PAGE
                .replace("%WIDTH%", str(self.config.width))
                .replace("%HEIGHT%", str(self.config.height))
                ).encode()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urllib.parse.urlparse(self.path).path
                if path == "/":
                    self._send(200, page, "text/html")
                elif path == "/frame.png":
                    self._send(200, viewer.render_frame(), "image/png")
                elif path == "/pose":
                    body = json.dumps(
                        {"pose": [float(x) for x in viewer.pose()],
                         "frames": viewer.frames_rendered,
                         "spp": viewer._accum_n * viewer.path_samples}
                    ).encode()
                    self._send(200, body, "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                u = urllib.parse.urlparse(self.path)
                q = urllib.parse.parse_qs(u.query)
                if u.path == "/drag":
                    viewer.on_drag(float(q.get("dx", ["0"])[0]),
                                   float(q.get("dy", ["0"])[0]))
                elif u.path == "/key":
                    viewer.on_key(q.get("k", [""])[0][:1])
                else:
                    self._send(404, b"not found", "text/plain")
                    return
                self._send(200, b"ok", "text/plain")

        return ThreadingHTTPServer((host, port), Handler)

    def serve(self, host: str = "127.0.0.1", port: int = 8000) -> None:
        # loopback by default: the viewer has no auth, and its POST
        # endpoints move the camera / its GET renders burn the chip —
        # pass host="0.0.0.0" explicitly to expose it (e.g. via the
        # driver's --web-host)
        srv = self.make_server(host, port)
        shown = "localhost" if host in ("0.0.0.0", "") else host
        print(f"live viewer on http://{shown}:{srv.server_address[1]}/ "
              "(drag to orbit, wasd/qe to fly, ctrl-c to stop)")
        try:
            srv.serve_forever()
        except KeyboardInterrupt:  # pragma: no cover
            pass
        finally:
            srv.server_close()
