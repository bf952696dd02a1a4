"""The live viewer (`runtime/viewer.py`, `ptx-torch serve`) and `ptx-torch
view` in the port against the JAX package's on the CPU. Mirrors
tests/test_viewer.py, whose tests are marked slow; none here is.

Each server binds port 0 (a free port), so the pytest workers never
collide. The engines run the triangle Cornell box without spheres at
16 x 16 and 2 bounces, fast mode, the port's 'bruteforce' against JAX op
by op (`jax.disable_jit()`, its XLA `first_intersect`), as
tests/test_torch_interactive.py does: their uint8 frames are equal."""

import ast
import io
import json
import pathlib
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu import cli as jcli
from opencl_path_tracer_tpu import config as jconfig
from opencl_path_tracer_tpu.io.image import to_uint8 as jto_uint8
from opencl_path_tracer_tpu.runtime import engine as jengine
from opencl_path_tracer_tpu.runtime import viewer as jviewer
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import cli
from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.io.image import png_bytes, read_png
from opencl_path_tracer_tpu_torch.runtime import engine, viewer
from opencl_path_tracer_tpu_torch.runtime.meter import PerfMeter
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

W = H = 16
CAM = dict(fov=60.0, yaw=0.0, pitch=0.0, shift=(0.0, 0.0, 0.0))
WAIT = 60.0   # seconds any one condition may take on a loaded machine


def _engine(**kw):
    cfg = RenderConfig(width=W, height=H, iterations=2, mode="fast",
                       accel="bruteforce", camera=CameraConfig(**CAM), **kw)
    eng = engine.RenderEngine(library.cornell_box(with_spheres=False), cfg,
                              device="cpu")
    eng.meter = PerfMeter(interval=1e9, stream=io.StringIO())
    return eng


def _get(base, path):
    return urllib.request.urlopen(base + path, timeout=WAIT).read()


def _stats(base):
    return json.loads(_get(base, "/stats"))


def _key(base, key, ev="keydown"):
    req = urllib.request.Request(
        base + "/input", data=json.dumps({"ev": ev, "key": key}).encode(),
        method="POST")
    return urllib.request.urlopen(req, timeout=WAIT).read()


def _until(cond, what):
    deadline = time.time() + WAIT
    while time.time() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _serve(v):
    httpd = v.serve(block=False)
    assert v.port == httpd.server_address[1] != 0
    return httpd, f"http://127.0.0.1:{v.port}"


def _close(v, httpd):
    v._stop.set()
    httpd.shutdown()
    httpd.server_close()
    v._render_thread.join(timeout=WAIT)
    assert not v._render_thread.is_alive()


def _jax_stats_keys():
    """The keys of the dict the JAX viewer's /stats handler dumps."""
    tree = ast.parse(pathlib.Path(jviewer.__file__).read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no /stats dict in the JAX viewer")


def test_page_is_the_jax_page():
    assert viewer._PAGE.encode() == jviewer._PAGE.encode()


def test_endpoints_input_and_denoise_toggle():
    v = viewer.ViewerServer(_engine(), port=0)
    httpd, base = _serve(v)
    try:
        png = _until(lambda: (lambda b: b.startswith(b"\x89PNG") and b)(
            _get(base, "/frame.png")), "a frame")
        assert png.startswith(b"\x89PNG")
        assert b"ptx viewer" in _get(base, "/")
        stats = _stats(base)
        assert list(stats) == _jax_stats_keys()
        assert stats["iterations"] == 2 and stats["error"] is None
        # '+' reaches the controller (depth 3).
        assert _key(base, "+") == b"ok"
        _until(lambda: _stats(base)["iterations"] == 3, "depth 3")
        assert v.engine.controller.state.iterations == 3
        # 'n' toggles the denoised display and frames keep coming.
        assert _stats(base)["denoise"] is False
        assert _key(base, "n") == b"ok"
        seq = v._seq
        _until(lambda: v._seq > seq + 2, "denoised frames")
        stats = _stats(base)
        assert stats["denoise"] is True and stats["error"] is None
        assert stats["viewer_fps"] > 0 and stats["samples"] > 0
        assert _get(base, "/frame.png").startswith(b"\x89PNG")
        assert _key(base, "n") == b"ok" and _stats(base)["denoise"] is False
        req = urllib.request.Request(base + "/other", data=b"", method="POST")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(req, timeout=WAIT)
    finally:
        _close(v, httpd)


@pytest.mark.parametrize("have_pil", [True, False])
def test_stream_and_png_with_and_without_pil(have_pil):
    """With PIL the stream pushes JPEG parts (at least two arrive without
    a request each); without it the stream answers 404. Either way
    /frame.png is the port's own encoder's PNG of the published frame."""
    v = viewer.ViewerServer(_engine(), port=0)
    v._have_pil = have_pil
    httpd, base = _serve(v)
    try:
        _until(lambda: v._seq > 0, "a frame")
        if have_pil:
            with urllib.request.urlopen(base + "/stream.mjpg",
                                        timeout=WAIT) as resp:
                assert "multipart/x-mixed-replace" in resp.headers[
                    "Content-Type"]
                blob = b""
                deadline = time.time() + WAIT
                while (blob.count(b"\xff\xd8") < 2
                       and time.time() < deadline):
                    blob += resp.read(4096)
            assert blob.count(b"\xff\xd8") >= 2
        else:
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(base, "/stream.mjpg")
            assert e.value.code == 404
        v._stop.set()
        v._render_thread.join(timeout=WAIT)
        frame = v._frame_u8
        png = _get(base, "/frame.png")
        assert png == png_bytes(frame)
        from PIL import Image
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(png)).convert("RGB")), frame)
    finally:
        _close(v, httpd)


def test_render_error_surfaces_and_esc_quits():
    v = viewer.ViewerServer(_engine(), port=0)

    def boom(dt=0.0, sync=True):
        raise RuntimeError("synthetic kernel failure")

    v.engine.frame = boom
    httpd, base = _serve(v)
    try:
        err = _until(lambda: _stats(base)["error"], "the error")
        assert "synthetic kernel failure" in err
        assert err.startswith("RuntimeError: ")
    finally:
        _close(v, httpd)
    # ESC: the controller's flag makes the render loop stop the server.
    v2 = viewer.ViewerServer(_engine(), port=0)
    httpd2, base2 = _serve(v2)
    try:
        _until(lambda: v2._seq > 0, "a frame")
        assert _key(base2, "Escape") == b"ok"
        _until(v2._stop.is_set, "ESC")
        v2._render_thread.join(timeout=WAIT)
        assert not v2._render_thread.is_alive()
        _until(lambda: httpd2.socket.fileno() == -1, "the socket closed")
    finally:
        _close(v2, httpd2)


def test_last_frame_equals_jax():
    """The loop shows frame N-1 while frame N renders: stopped after its
    fifth frame, the viewer has published four, and the last is the JAX
    engine's to_uint8(image()) after four frames."""
    v = viewer.ViewerServer(_engine(), port=0)
    eng = v.engine
    real = eng.frame
    calls = []

    def counted(dt=0.0, sync=True):
        real(dt, sync)
        calls.append(sync)
        if len(calls) == 5:
            v._stop.set()

    eng.frame = counted
    httpd, _ = _serve(v)
    try:
        v._render_thread.join(timeout=WAIT)
        assert not v._render_thread.is_alive()
    finally:
        _close(v, httpd)
    assert calls == [False] * 5 and v._seq == 4 and v.last_error is None
    je = jengine.RenderEngine(
        jlib.cornell_box(with_spheres=False),
        jconfig.RenderConfig(width=W, height=H, iterations=2, mode="fast",
                             accel="bruteforce",
                             camera=jconfig.CameraConfig(**CAM)))
    with jax.disable_jit():
        for _ in range(4):
            je.frame(0.016)
        ref = jto_uint8(je.image())
    np.testing.assert_array_equal(v._frame_u8, ref)
    assert v._frame_u8.flags["C_CONTIGUOUS"] and ref.max() > 0


VIEW = ["view", "--scene", "cornell-empty", "--size", f"{W}x{H}",
        "--iters", "2", "--frames", "3", "--accel", "bruteforce"]


def test_cli_view_equals_jax_and_passes_the_seed(tmp_path, monkeypatch,
                                                 capsys):
    """`ptx-torch view` writes JAX `ptx view`'s PNG. A divergence on
    purpose (ROADMAP.md queue 3): JAX's view and serve parse --seed and
    drop it (their RenderConfig takes no seed=); the port's pass it."""
    outs = {}
    for seed in ("1", "7"):
        with jax.disable_jit():
            assert jcli.main(VIEW + ["--seed", seed, "--out",
                                     str(tmp_path / f"j{seed}.png")]) == 0
        assert cli.main(VIEW + ["--seed", seed, "--device", "cpu", "--out",
                                str(tmp_path / f"p{seed}.png")]) == 0
        outs[seed] = [read_png(str(tmp_path / f"{w}{seed}.png"))
                      for w in "jp"]
    assert "wrote " in capsys.readouterr().err
    np.testing.assert_array_equal(outs["1"][1], outs["1"][0])
    np.testing.assert_array_equal(outs["7"][0], outs["1"][0])   # dropped
    assert not np.array_equal(outs["7"][1], outs["1"][1])       # passed
    seen = []
    real = engine.RenderEngine

    def spy(scene, cfg, *a, **k):
        seen.append(cfg.seed)
        return real(scene, cfg, *a, **k)

    monkeypatch.setattr(engine, "RenderEngine", spy)
    monkeypatch.setattr(viewer.ViewerServer, "serve", lambda self: None)
    assert cli.main(["serve", "--seed", "9", "--size", "8x8",
                     "--device", "cpu", "--port", "0"]) == 0
    assert cli.main(VIEW + ["--seed", "5", "--frames", "1", "--device",
                            "cpu", "--out", str(tmp_path / "s.png")]) == 0
    assert seen == [9, 5]


@pytest.mark.parametrize("cmd", ["view", "serve"])
def test_refuses_without_a_gpu(cmd, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([cmd, "--size", "8x8"])


@pytest.mark.parametrize("cmd", ["view", "serve"])
def test_exits_nonzero_without_a_gpu(cmd, tmp_path):
    if torch.cuda.is_available():
        pytest.skip(f"needs a machine without a GPU: `{cmd}` exits non-zero "
                    "there")
    extra = ["--port", "0"] if cmd == "serve" else [
        "--out", str(tmp_path / "v.png")]
    r = subprocess.run([sys.executable, "-m", "opencl_path_tracer_tpu_torch"
                        ".cli", cmd, "--size", "8x8", *extra],
                       capture_output=True, text=True, timeout=WAIT)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert not (tmp_path / "v.png").exists()
