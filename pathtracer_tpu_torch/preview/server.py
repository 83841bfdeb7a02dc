"""Interactive web preview.

Port of `pathtracer_tpu/preview/server.py`: a zero-dependency HTTP preview
in place of the reference's OpenGL window.  A background HTTP server serves
the progressively converging frame and its statistics and takes camera
orbits, dollies, pans, mode switches, resets and saves, which the render
loop applies between chunks of samples (an `accum_resets` event counts
each restart of accumulation).  The page and the PNG writer are copies of
the JAX package's (tests/test_torch_hostcode.py holds them equal).

On the card, `run_preview` and `start_preview_thread` build the kernels in
the calling thread before the server starts, so that nvcc never runs under
the HTTP server.  A mode
switch drops the old renderer before the new one builds its tables, so the
tables are never held twice on the device.  `snapshot` reads the image back
once a chunk.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

# copied from pathtracer_tpu/preview/server.py _PAGE
_PAGE = """<!DOCTYPE html>
<html><head><title>pathtracer_tpu preview</title>
<style>
 body { background:#181818; color:#ddd; font-family:monospace; margin:14px; }
 #wrap { display:flex; gap:18px; }
 img { image-rendering:pixelated; border:1px solid #444; cursor:grab; }
 table td { padding:1px 8px; }
 select,button { background:#282828; color:#ddd; border:1px solid #555; }
</style></head>
<body>
<div id="wrap">
 <img id="frame" src="/frame.png" draggable="false">
 <div>
  <h3>pathtracer_tpu</h3>
  <table id="stats"></table>
  <p>mode <select id="mode">
    <option value="0">BSDF</option><option value="1">DirectLight</option>
    <option value="2">MIS</option></select>
   <button onclick="fetch('/reset')">reset</button>
   <button onclick="fetch('/save')">save PNG</button></p>
  <p>left-drag orbit · right-drag zoom · middle-drag pan
     (reference mouse parity)</p>
 </div>
</div>
<script>
const img = document.getElementById('frame');
img.oncontextmenu = e => e.preventDefault();
let drag = null, btn = 0;
img.onmousedown = e => { drag = [e.clientX, e.clientY]; btn = e.button; };
window.onmouseup = () => { drag = null; };
window.onmousemove = e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY];
  if (btn === 0)      // left: orbit (reference src/main.cpp:255-261)
    fetch(`/orbit?dphi=${dx*0.4}&dtheta=${-dy*0.4}`);
  else if (btn === 2) // right: dolly (reference src/main.cpp:263-266)
    fetch(`/zoom?dy=${dy/img.height}`);
  else if (btn === 1) // middle: pan (reference src/main.cpp:268-281)
    fetch(`/pan?dx=${dx}&dy=${dy}`);
};
document.getElementById('mode').onchange = e => fetch('/mode?m='+e.target.value);
setInterval(() => { img.src = '/frame.png?' + Date.now(); }, 900);
setInterval(async () => {
  const s = await (await fetch('/stats.json')).json();
  document.getElementById('stats').innerHTML =
    Object.entries(s).map(([k,v]) => `<tr><td>${k}</td><td>${v}</td></tr>`).join('');
}, 900);
</script></body></html>"""


class PreviewState:
    """Shared state between the render loop and HTTP threads."""

    def __init__(self, renderer):
        self.renderer = renderer
        self.lock = threading.Lock()
        self.pending_orbit = None   # (dtheta, dphi)
        self.pending_zoom = None    # dy fraction (right drag)
        self.pending_pan = None     # (dx_px, dy_px) (middle drag)
        self.pending_mode = None
        self.pending_reset = False
        self.pending_save = False
        self.frame_png = b""
        self.stats = {}
        self.running = True
        # monotonically increments whenever accumulation restarts: an event
        # to wait on (sampling renderer.iteration races with the render
        # loop advancing it again)
        self.accum_resets = 0

    def snapshot(self):
        r = self.renderer
        buf = io.BytesIO()
        img = r.ldr_image()[:, ::-1]  # the reference saves X-mirrored
        _write_png_bytes(buf, img)
        with self.lock:
            self.frame_png = buf.getvalue()
            self.stats = {
                "iteration": r.iteration,
                "mode": r.opts.sample_mode.name,
                "Mrays/s": round(r.stats.mrays_per_sec, 2),
                # the live depth reached last iteration, not the scene's maximum
                "traced depth": r.traced_depth,
                "triangles": r.static.num_tris,
                "BVH nodes": r.static.num_bvh_nodes,
                "resolution": f"{r.width}x{r.height}",
                "camera": "(%.2f, %.2f, %.2f)" % tuple(r.camera.position),
                "theta/phi": "%.1f / %.1f" % (r.camera.theta, r.camera.phi),
                "resets": self.accum_resets,
            }

    def apply_pending(self):
        """Called by the render loop between chunks."""
        with self.lock:
            orbit, self.pending_orbit = self.pending_orbit, None
            zoom, self.pending_zoom = self.pending_zoom, None
            pan, self.pending_pan = self.pending_pan, None
            mode, self.pending_mode = self.pending_mode, None
            reset, self.pending_reset = self.pending_reset, False
            save, self.pending_save = self.pending_save, False
        restarted = False
        if mode is not None and int(mode) != int(self.renderer.opts.sample_mode):
            from pathtracer_tpu_torch.integrator.render import Renderer

            r = self.renderer
            scene, opts, camera, device = r.scene, r.opts, r.camera, r.device
            size, depth = (r.width, r.height), r.static.trace_depth
            # free the old tables before the new ones are built
            self.renderer = r = None
            new = Renderer(scene, opts=opts.with_mode(int(mode)), resolution=size,
                           trace_depth=depth, device=device)
            new.camera = camera
            self.renderer = new
            restarted = True
        if orbit is not None:
            dtheta, dphi = orbit
            cam = self.renderer.camera
            theta = float(np.clip(cam.theta + dtheta, -89.0, 89.0))
            self.renderer.set_orbit(theta, cam.phi + dphi)
            restarted = True
        if zoom is not None:
            self.renderer.zoom(float(zoom))
            restarted = True
        if pan is not None:
            self.renderer.pan(float(pan[0]), float(pan[1]))
            restarted = True
        if reset:
            self.renderer.reset()
            restarted = True
        if save:
            self.renderer.save_png(f"{self.renderer.static.image_name}.preview.png")
        if restarted:
            with self.lock:
                self.accum_resets += 1


# copied from pathtracer_tpu/preview/server.py
def _write_png_bytes(buf, img):
    import struct
    import zlib

    arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag, payload):
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    buf.write(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 3))
        + chunk(b"IEND", b"")
    )


def make_handler(state: PreviewState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            if url.path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif url.path == "/frame.png":
                with state.lock:
                    png = state.frame_png
                self._send(200, "image/png", png or b"")
            elif url.path == "/stats.json":
                with state.lock:
                    body = json.dumps(state.stats).encode()
                self._send(200, "application/json", body)
            elif url.path == "/orbit":
                with state.lock:
                    dt = float(q.get("dtheta", ["0"])[0])
                    dp = float(q.get("dphi", ["0"])[0])
                    if state.pending_orbit:
                        dt += state.pending_orbit[0]
                        dp += state.pending_orbit[1]
                    state.pending_orbit = (dt, dp)
                self._send(200, "text/plain", b"ok")
            elif url.path == "/zoom":
                with state.lock:
                    dy = float(q.get("dy", ["0"])[0])
                    if state.pending_zoom:
                        dy += state.pending_zoom
                    state.pending_zoom = dy
                self._send(200, "text/plain", b"ok")
            elif url.path == "/pan":
                with state.lock:
                    dx = float(q.get("dx", ["0"])[0])
                    dy = float(q.get("dy", ["0"])[0])
                    if state.pending_pan:
                        dx += state.pending_pan[0]
                        dy += state.pending_pan[1]
                    state.pending_pan = (dx, dy)
                self._send(200, "text/plain", b"ok")
            elif url.path == "/mode":
                with state.lock:
                    state.pending_mode = int(q.get("m", ["0"])[0])
                self._send(200, "text/plain", b"ok")
            elif url.path == "/reset":
                with state.lock:
                    state.pending_reset = True
                self._send(200, "text/plain", b"ok")
            elif url.path == "/save":
                with state.lock:
                    state.pending_save = True
                self._send(200, "text/plain", b"ok")
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


def _build_kernels(renderer) -> None:
    """On the card, build the kernels in the calling thread, before any
    server thread runs."""
    if renderer.device.type == "cuda":
        from pathtracer_tpu_torch.ops import _build

        _build.load_library()


def run_preview(renderer, host="127.0.0.1", port=8000, chunk=4, max_iterations=None):
    """Blocking preview loop: render `chunk` spp, publish frame, repeat."""
    _build_kernels(renderer)
    state = PreviewState(renderer)
    del renderer  # the state holds the renderer, which a mode switch replaces
    server = ThreadingHTTPServer((host, port), make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    print(f"preview at http://{host}:{server.server_address[1]}/")
    try:
        while state.running:
            state.apply_pending()
            r = state.renderer
            limit = max_iterations if max_iterations is not None else r.static.iterations
            if r.iteration < limit:
                r.step(chunk)
            else:
                time.sleep(0.2)
            del r
            state.snapshot()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
    return state


def start_preview_thread(renderer, host="127.0.0.1", port=0, chunk=2):
    """Non-blocking variant for tests: returns (state, server, loop_thread)."""
    _build_kernels(renderer)
    state = PreviewState(renderer)
    del renderer
    server = ThreadingHTTPServer((host, port), make_handler(state))
    srv_thread = threading.Thread(target=server.serve_forever, daemon=True)
    srv_thread.start()

    def loop():
        while state.running:
            state.apply_pending()
            state.renderer.step(chunk)
            state.snapshot()

    loop_thread = threading.Thread(target=loop, daemon=True)
    loop_thread.start()
    return state, server, loop_thread
