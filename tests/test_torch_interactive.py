"""The engine's interactive state in the port against the JAX package's
engine on the CPU: `frame`, `reset_accumulation`, `estimated_rays`,
`display_u8` and `display_u8_device`, the wavefront's reset when the pose
moves, the meter's ticks (`progress=`), and `ptx-torch info`. Mirrors
tests/test_runtime.py's engine tests.

Both engines run the triangle Cornell box without spheres
('cornell-empty') at 16 x 16 and 2 bounces, JAX op by op
(`jax.disable_jit()`, its XLA `first_intersect`) against the port's
'bruteforce'. The JAX engine evaluates its samples through
`lift_consts`' jaxpr, which rounds a few colors an ulp away from its
model's op-by-op samples (tests/test_torch_adaptive.py), so colors hold
to rtol 1e-6 and atol 1e-7; the Lehmer states, sample counters, ray
counts and the uint8 display frames are equal."""

import io
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu import config as jconfig
from opencl_path_tracer_tpu.runtime import engine as jengine
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import cli
from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.models import megakernel
from opencl_path_tracer_tpu_torch.parallel import mesh
from opencl_path_tracer_tpu_torch.runtime import engine
from opencl_path_tracer_tpu_torch.runtime.meter import PerfMeter
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

W = H = 16
CAM = dict(fov=60.0, yaw=0.0, pitch=0.0, shift=(0.0, 0.0, 0.0))


def _engines(model="megakernel", mode="parity", **kw):
    js = jlib.cornell_box(with_spheres=False)
    ps = library.cornell_box(with_spheres=False)
    jcfg = jconfig.RenderConfig(width=W, height=H, iterations=2, mode=mode,
                                model=model, accel="bruteforce",
                                camera=jconfig.CameraConfig(**CAM), **kw)
    pcfg = RenderConfig(width=W, height=H, iterations=2, mode=mode,
                        model=model, accel="bruteforce",
                        camera=CameraConfig(**CAM), **kw)
    je = jengine.RenderEngine(js, jcfg)
    pe = engine.RenderEngine(ps, pcfg, device="cpu")
    for e in (je, pe):
        e.meter = PerfMeter(interval=1e9, stream=io.StringIO())
    return je, pe


def _colors(e):
    c = e.state.colors
    return np.stack([np.asarray(x) if not isinstance(x, torch.Tensor)
                     else x.numpy() for x in c], -1)


SCRIPT = [(), (), ("down", "w"), (), ("up", "w"), (), ("down", "+"), (),
          ("button", True, 4, 4), ("motion", 9, 6), ("button", False, 9, 6),
          (), (), ("down", "-"), ()]


def _event(ctl, ev):
    if not ev:
        return
    if ev[0] == "down":
        ctl.key_down(ev[1])
    elif ev[0] == "up":
        ctl.key_up(ev[1])
    elif ev[0] == "button":
        ctl.mouse_button(*ev[1:])
    else:
        ctl.mouse_motion(*ev[1:])


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_frames_and_resets_equal_jax(mode):
    """Frames with key, button and depth events: the sample counter
    restarts on every move and release (main.cpp:1098-1148), the Lehmer
    streams run on, and every frame equals the JAX engine's."""
    je, pe = _engines(mode=mode)
    samples = []
    for ev in SCRIPT:
        _event(je.controller, ev)
        _event(pe.controller, ev)
        with jax.disable_jit():
            je.frame(0.016)
        pe.frame(0.016)
        assert pe._sample_host == je._sample_host
        assert pe.state.sample == int(je.state.sample)
        assert pe.iterations == je.controller.state.iterations
        np.testing.assert_allclose(_colors(pe), _colors(je), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_array_equal(
            pe.state.rng_state.numpy(),
            np.asarray(je.state.rng_state).astype(np.int64))
        samples.append(pe.state.sample)
    assert samples == [1, 2, 1, 1, 1, 2, 1, 2, 1, 1, 1, 2, 3, 1, 2]
    assert pe.estimated_rays(7) == je.estimated_rays(7) > 0
    assert pe.rays_traced > 0


def test_reset_keeps_lehmer_streams():
    _, pe = _engines()
    pe.frame(0.0)
    pe.frame(0.0)
    rng_state = pe.state.rng_state.clone()
    pe.reset_accumulation()
    assert pe.state.sample == 0 and pe._sample_host == 0
    assert torch.equal(pe.state.rng_state, rng_state)
    pe.frame(0.0)
    assert pe.state.sample == 1


def test_fast_frames_after_reset_equal_a_fresh_engine():
    """Fast-mode draws key on the sample counter: after a move, the frames
    at the new pose equal a fresh engine's samples there, bit for bit
    (chip_smoke.py checks the same at 1080p on the card)."""
    ps = library.cornell_box(with_spheres=True)
    cfg = RenderConfig(width=W, height=H, iterations=3, mode="fast",
                       camera=CameraConfig(**CAM))
    e = engine.RenderEngine(ps, cfg, device="cpu")
    e.meter = PerfMeter(interval=1e9, stream=io.StringIO())
    for _ in range(4):
        e.frame(1 / 60)
    e.controller.key_down("w")
    for _ in range(3):
        e.frame(1 / 60)
    e.controller.key_up("w")
    for _ in range(6):
        e.frame(1 / 60)
    assert e.state.sample == 6
    moved = CameraConfig(**dict(CAM, shift=tuple(e.controller.state.shift)))
    fresh = engine.RenderEngine(
        ps, RenderConfig(width=W, height=H, iterations=3, mode="fast",
                         camera=moved), device="cpu")
    fresh.render(6, progress=False)
    assert torch.equal(megakernel.colors_array(e.state),
                       megakernel.colors_array(fresh.state))


def test_frame_sync_cadence_and_camera_reuse(monkeypatch):
    """Real time syncs every frame; 'r' (offline) every third sample; an
    idle frame reuses the controller's camera tensors."""
    _, pe = _engines(mode="fast")
    calls = []
    monkeypatch.setattr(pe, "_sync", lambda: calls.append(pe._sample_host))
    cam = pe.camera
    for _ in range(3):
        pe.frame(0.016)
    assert calls == [1, 2, 3] and pe.camera is cam
    pe.controller.key_down("r")
    calls.clear()
    for _ in range(6):
        pe.frame(0.016)
    assert calls == [6, 9]
    calls.clear()
    pe.frame(0.016, sync=False)
    assert calls == []


def test_display_u8_equals_jax():
    for model in ("megakernel", "wavefront"):
        je, pe = _engines(model=model, mode="fast")
        with jax.disable_jit():
            if model == "megakernel":
                je.frame(0.016)
                je.frame(0.016)
            else:
                je.render(2, progress=False)
            ref = je.display_u8()
        if model == "megakernel":
            pe.frame(0.016)
            pe.frame(0.016)
        else:
            pe.render(2, progress=False)
        dev = pe.display_u8_device()
        assert dev.dtype == torch.uint8 and dev.shape == (H, W, 3)
        np.testing.assert_array_equal(pe.display_u8(), ref)
        np.testing.assert_array_equal(dev.numpy()[::-1], ref)
        assert ref.max() > 0


def test_display_u8_nan_inf_rule_and_lanes():
    """NaN -> 0, +inf -> 255 (io.image.to_uint8); a wavefront state with
    two lanes per pixel shows their sample-weighted average."""
    from opencl_path_tracer_tpu_torch.io.image import to_uint8
    _, pe = _engines(mode="fast", tonemap="none")
    pe.frame(0.0)
    vals = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.5,
                         2.0, -1.0])
    col = vals.repeat(W * H // 6 + 1)[:W * H]
    pe.state = megakernel.TraceState(colors=(col, col.clone(), col.clone()),
                                     rng_state=pe.state.rng_state, sample=1)
    img = torch.stack(pe.state.colors, -1).reshape(H, W, 3).numpy()[::-1]
    np.testing.assert_array_equal(pe.display_u8(), to_uint8(img))
    _, we = _engines(model="wavefront", mode="fast", tonemap="none")
    we.render(2, progress=False)
    from opencl_path_tracer_tpu_torch.models import wavefront
    two = wavefront.state_concat([we.state, we.state])
    we.state, we._display = two, None
    np.testing.assert_array_equal(
        we.display_u8(),
        to_uint8(wavefront.colors_by_pixel(two, W * H).reshape(H, W, 3)
                 .numpy()[::-1]))


def test_frame_refuses_the_wavefront():
    _, pe = _engines(model="wavefront")
    with pytest.raises(ValueError, match="megakernel"):
        pe.frame(0.016)


def test_wavefront_resets_when_the_pose_moved():
    """A render after a move restarts the accumulation at the new pose.
    The JAX engine compares the pose key of the last camera it built, so
    it resets one render late (its first render after the move mixes the
    new pose into the old average; ROADMAP.md queue 3); building its
    camera first makes it reset on time, and then the two agree."""
    je, pe = _engines(model="wavefront", mode="parity")
    with jax.disable_jit():
        je.render(2, progress=False)
    pe.render(2, progress=False)
    for e in (je, pe):
        e.controller.key_down("d")
        e.controller.update(0.05)
        e.controller.key_up("d")
    je.controller.camera(W, H)
    with jax.disable_jit():
        je.render(1, progress=False)
    pe.render(1, progress=False)
    assert pe._sample_host == je._sample_host == 1
    np.testing.assert_array_equal(pe.state.samples.numpy(),
                                  np.asarray(je.state.samples))
    np.testing.assert_allclose(pe.image(apply_tonemap=False),
                               je.image(apply_tonemap=False), rtol=1e-6,
                               atol=1e-7)
    assert pe._wf_pose == pe.controller._cam_key
    pe.controller.key_down("+")           # depth: no new pose, no reset
    pe.render(1, progress=False)
    assert pe._sample_host == 2


def test_progress_ticks_the_meter():
    _, pe = _engines(mode="fast")
    buf = io.StringIO()
    pe.meter = PerfMeter(interval=-1.0, stream=buf)
    pe.render(3)
    assert buf.getvalue().count("Samples=") == 3
    assert "Mrays/sec" in buf.getvalue()
    pe.render(2, progress=False)
    assert buf.getvalue().count("Samples=") == 3
    _, we = _engines(model="wavefront", mode="fast")
    we.meter = PerfMeter(interval=-1.0, stream=buf)
    we.render(2)
    we.render_adaptive(0.3, max_spp=6, min_spp=3)
    assert buf.getvalue().count("Samples=") >= 5


def test_estimated_rays_wavefront_is_exact():
    je, pe = _engines(model="wavefront", mode="parity")
    with jax.disable_jit():
        je.render(2, progress=False)
    pe.render(2, progress=False)
    assert pe.estimated_rays(99) == je.estimated_rays(99) == pe.rays_traced


def test_info_command_and_device_table(capsys, monkeypatch):
    assert cli.main(["info", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "backend: cpu" in out
    assert "1. Device: cpu (platform=cpu, process=0)" in out
    assert mesh.describe_devices(verbose=False, device="cpu") == [
        {"id": 0, "platform": "cpu", "kind": "cpu", "process": 0,
         "bytes_limit": None}]

    class Props:
        total_memory = 85_000_000_000

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: f"NVIDIA H100 80GB HBM3 #{i}")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props())
    rows = mesh.describe_devices()
    assert [r["id"] for r in rows] == [0, 1]
    assert rows[1] == {"id": 1, "platform": "gpu",
                       "kind": "NVIDIA H100 80GB HBM3 #1", "process": 0,
                       "bytes_limit": 85_000_000_000}
    assert "2. Device: NVIDIA H100 80GB HBM3 #1 (platform=gpu, process=0)" \
        in capsys.readouterr().out


def test_info_refuses_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["info"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.describe_devices()


def test_info_exits_nonzero_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a GPU: `info` exits non-zero "
                    "there")
    r = subprocess.run([sys.executable, "-m", "opencl_path_tracer_tpu_torch"
                        ".cli", "info"], capture_output=True, text=True)
    assert r.returncode != 0 and "no CUDA device" in r.stderr


def test_cli_render_cornell_empty_prints_the_meter(tmp_path, capsys):
    out = tmp_path / "e.png"
    assert cli.main(["render", "--scene", "cornell-empty", "--size", "8x8",
                     "--spp", "2", "--iters", "2", "--device", "cpu",
                     "--out", str(out)]) == 0
    err = capsys.readouterr().err
    assert "\n2 spp in " in err and out.exists()
