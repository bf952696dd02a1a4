"""Live browser viewer.

Port of `opencl_path_tracer_tpu/runtime/viewer.py`: the headless stand-in
for the reference's GLUT window and CL/GL display (onDisplay,
main.cpp:1019-1039). One HTML page shows the progressive framebuffer and
sends the keyboard and the mouse to the CameraController with the
reference's bindings (WASD/QY fly, E/C zoom, drag to look, +/- bounce
depth, r real time, space full screen, ESC quits); 'n' toggles a
denoised display (`RenderEngine.denoised_image`), a viewer key of the
JAX package's. A background thread calls `RenderEngine.frame()` in a
loop, the onIdle loop (main.cpp:1171-1241), with the input's
accumulation resets.

Frames are pushed over an MJPEG stream (`/stream.mjpg`,
multipart/x-mixed-replace) as they are rendered, where PIL is installed;
without PIL the stream answers 404 and the page polls `/frame.png`.
The port's own PNG encoder (`io.image.png_bytes`) writes `/frame.png`
in memory, with PIL or without. `/stats` is the same JSON as the JAX package's; `POST /input`
takes the page's events.

The display fetch is double-buffered: each loop enqueues frame N's
sample and its device tonemap (`display_u8_device`) on the engine's
device and default stream, starts its copy into pinned host memory
without blocking, and records a CUDA event; then it waits for frame
N-1's event and publishes frame N-1, rows flipped on the host. Frame
N-1's device tensor stays referenced until its event has completed, so
the caching allocator cannot hand its memory to another tensor while the
copy is in flight. The JAX package's mesh-sharded fallback is left out:
the port has no mesh, and `display_u8_device` always returns a tensor.

Usage:
    ptx-torch serve --scene cornell --size 512x512   # then open the URL
"""

from __future__ import annotations

import io
import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.io.image import png_bytes, to_uint8

_PAGE = """<!doctype html>
<html><head><title>ptx viewer</title><style>
body{margin:0;background:#111;color:#ddd;font:13px monospace;
     display:flex;flex-direction:column;align-items:center}
img{image-rendering:pixelated;margin-top:8px;outline:none}
#hud{padding:6px}
</style></head><body>
<div id="hud">loading…</div>
<img id="fb" tabindex="0" draggable="false">
<script>
const img = document.getElementById('fb');
const hud = document.getElementById('hud');
let dragging = false;
let polling = false;
function send(ev, data) {
  fetch('/input', {method:'POST',
    body: JSON.stringify({ev: ev, ...data})});
}
function startStream() {
  img.src = '/stream.mjpg';
  img.onerror = () => {  // no Pillow server-side: poll PNG instead
    polling = true;
    img.onerror = null;
    setInterval(() => { img.src = '/frame.png?' + Date.now(); }, 100);
  };
}
window.addEventListener('keydown', e => {
  if (!e.repeat) {
    if (e.key === ' ') {  // fullscreen: needs this user gesture
      if (document.fullscreenElement) document.exitFullscreen();
      else img.requestFullscreen();
    }
    send('keydown', {key: e.key});
  }
  e.preventDefault();});
window.addEventListener('keyup', e => {
  send('keyup', {key: e.key}); e.preventDefault();});
img.addEventListener('mousedown', e => {
  dragging = true; send('mousedown', {x: e.offsetX, y: e.offsetY});});
window.addEventListener('mouseup', e => {
  dragging = false; send('mouseup', {x: 0, y: 0});});
img.addEventListener('mousemove', e => {
  if (dragging) send('mousemove', {x: e.offsetX, y: e.offsetY});});
async function tick() {
  const r = await fetch('/stats');
  const s = await r.json();
  if (s.error) { hud.textContent = 'RENDER ERROR: ' + s.error; return; }
  hud.textContent = `samples=${s.samples}  ` +
    `samples/s=${s.samples_per_sec.toFixed(2)}  ` +
    `fps=${s.viewer_fps.toFixed(1)}${polling ? ' (poll)' : ''}  ` +
    `iterations=${s.iterations}  realtime=${s.real_time}  ` +
    `denoise=${s.denoise}  ` +
    `[WASD/QY fly, drag look, E/C zoom, +/- bounces, R realtime, ` +
    `N denoise, SPACE fullscreen, ESC quit]`;
}
setInterval(tick, 500); tick(); startStream();
</script></body></html>"""


class ViewerServer:
    """The viewer of one RenderEngine (model='megakernel': the interactive
    loop). port=0 binds a free port; `port` holds the bound one once
    `serve` has bound it."""

    def __init__(self, engine, host: str = "127.0.0.1",
                 port: int = 8642) -> None:
        self.engine = engine
        self.host = host
        self.port = port
        self._lock = threading.Lock()
        self._cond = threading.Condition()
        self._frame_u8: np.ndarray | None = None
        self._frame_jpg: bytes = b""
        self._seq = 0
        self.viewer_fps = 0.0
        self._stop = threading.Event()
        self._httpd = None
        self._render_thread: threading.Thread | None = None
        self.last_error: str | None = None
        self.denoise = False
        try:
            from PIL import Image  # noqa: F401
            self._have_pil = True
        except ImportError:
            self._have_pil = False

    # --- render thread (the onIdle loop) ---------------------------------
    def _render_loop(self) -> None:
        try:
            self._render_loop_inner()
        except Exception as exc:  # surface in /stats instead of dying mute
            self.last_error = f"{type(exc).__name__}: {exc}"
            traceback.print_exc()

    def _fetch(self, dev: torch.Tensor):
        """Start frame `dev`'s host copy: (device tensor, host tensor,
        event). On CUDA the copy goes into pinned memory without blocking
        and the event is recorded behind it on the current stream of the
        tensor's device."""
        if dev.device.type != "cuda":
            return dev, dev, None
        host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        host.copy_(dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev.device))
        return dev, host, event

    @staticmethod
    def _finish(fetch) -> np.ndarray:
        """Wait for a `_fetch`'s copy and return its frame, top row
        first; the device tensor is released only after that."""
        _dev, host, event = fetch
        if event is not None:
            event.synchronize()
        return np.ascontiguousarray(host.numpy()[::-1])

    def _render_loop_inner(self) -> None:
        last = time.time()
        first = True
        pending = None   # the _fetch of the frame not shown yet
        while not self._stop.is_set():
            if self.engine.controller.state.quit_requested:
                self.shutdown()  # ESC (main.cpp:1055-1058)
                return
            now = time.time()
            with self._lock:
                if self.denoise:
                    # The denoised display runs synchronously (the filter
                    # returns a host image); the frame in flight is
                    # dropped, once its copy has ended, so the order
                    # holds.
                    if pending is not None:
                        self._finish(pending)
                        pending = None
                    self.engine.frame(dt=now - last)
                    u8 = to_uint8(self.engine.denoised_image())
                else:
                    self.engine.frame(dt=now - last, sync=False)
                    fetch = self._fetch(self.engine.display_u8_device())
                    u8 = self._finish(pending) if pending is not None else None
                    pending = fetch
            dt = max(now - last, 1e-6)
            if not first:  # the first dt is the loop's entry, not a frame
                self.viewer_fps = (0.8 * self.viewer_fps + 0.2 / dt
                                   if self.viewer_fps else 1.0 / dt)
            first = False
            last = now
            if u8 is None:
                continue  # the first double-buffered frame: nothing yet
            jpg = b""
            if self._have_pil:
                from PIL import Image
                buf = io.BytesIO()
                Image.fromarray(u8, "RGB").save(buf, format="JPEG",
                                                quality=85)
                jpg = buf.getvalue()
            with self._cond:
                self._frame_u8 = u8
                self._frame_jpg = jpg
                self._seq += 1
                self._cond.notify_all()

    def _encode_png(self) -> bytes:
        """The last frame as a lossless PNG through `io.image.png_bytes`,
        in memory, encoded per /frame.png request only (the stream ships
        JPEG)."""
        with self._cond:
            u8 = self._frame_u8
        if u8 is None:
            return b""
        return png_bytes(u8)

    def _handle_input(self, msg: dict) -> None:
        ctl = self.engine.controller
        ev = msg.get("ev")
        key = str(msg.get("key", "")).lower()
        with self._lock:
            if ev == "keydown":
                if key == "n":  # the viewer's own key: denoised display
                    self.denoise = not self.denoise
                    return
                ctl.key_down(key)
            elif ev == "keyup":
                ctl.key_up(key)
            elif ev == "mousedown":
                ctl.mouse_button(True, int(msg["x"]), int(msg["y"]))
            elif ev == "mouseup":
                ctl.mouse_button(False)
            elif ev == "mousemove":
                ctl.mouse_motion(int(msg["x"]), int(msg["y"]))

    def stats(self) -> dict:
        """/stats: the JAX viewer's eight keys."""
        eng = self.engine
        st = eng.controller.state
        return {
            "samples": eng._sample_host,
            "samples_per_sec": eng.meter.last_samples_per_sec,
            "viewer_fps": self.viewer_fps,
            "iterations": st.iterations,
            "real_time": st.real_time,
            "fullscreen": st.fullscreen,
            "denoise": self.denoise,
            "error": self.last_error,
        }

    def shutdown(self) -> None:
        """Stop the render loop and the HTTP server (the ESC path)."""
        self._stop.set()
        with self._cond:
            self._cond.notify_all()  # release the stream handlers
        httpd = self._httpd
        if httpd is not None:
            def close():
                httpd.shutdown()
                httpd.server_close()
            threading.Thread(target=close, daemon=True).start()

    def serve(self, block: bool = True):
        """Start the render thread and the HTTP server on (host, port).
        block=True serves until ESC or an interrupt; block=False serves
        from a daemon thread and returns the server."""
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    self._send(200, "image/png", viewer._encode_png())
                elif self.path.startswith("/stream.mjpg"):
                    if not viewer._have_pil:
                        self._send(404, "text/plain", b"no jpeg codec")
                        return
                    self._stream()
                elif self.path.startswith("/stats"):
                    self._send(200, "application/json",
                               json.dumps(viewer.stats()).encode())
                else:
                    self._send(200, "text/html", _PAGE.encode())

            def _stream(self):
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=ptxframe")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                seen = -1
                try:
                    while not viewer._stop.is_set():
                        with viewer._cond:
                            if viewer._seq == seen:
                                viewer._cond.wait(timeout=2.0)
                            if viewer._seq == seen:
                                continue  # a stalled engine: wait again
                            seen = viewer._seq
                            jpg = viewer._frame_jpg
                        if not jpg:
                            continue
                        self.wfile.write(
                            b"--ptxframe\r\nContent-Type: image/jpeg\r\n"
                            b"Content-Length: " + str(len(jpg)).encode()
                            + b"\r\n\r\n" + jpg + b"\r\n")
                except OSError:
                    return  # the client went away

            def do_POST(self):
                if self.path == "/input":
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        viewer._handle_input(json.loads(self.rfile.read(n)))
                    except (ValueError, KeyError):
                        pass
                    self._send(200, "text/plain", b"ok")
                else:
                    self._send(404, "text/plain", b"")

        httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._render_thread = threading.Thread(target=self._render_loop,
                                               daemon=True)
        self._render_thread.start()
        print(f"ptx-torch viewer at http://{self.host}:{self.port}/")
        if not block:
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            return httpd
        try:
            httpd.serve_forever()
        finally:
            self._stop.set()
            httpd.server_close()
