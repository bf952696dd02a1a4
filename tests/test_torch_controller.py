"""The interactive camera controller (`runtime/controller.py`) and the
1 Hz meter (`runtime/meter.py`) against the JAX package's on the CPU.

The same key, mouse and `update` sequences give bit-equal
`ControllerState` fields (fov, yaw, pitch, depth and flags) and, where
XLA's float32 cos and sin of the pose's yaw and pitch are correctly
rounded, a bit-equal camera and shift (the float64 shift moves along the
float32 rotated basis, as in JAX). At about 1.4 % of angles (315 cos
and 289 sin values of 22,884 angles) XLA's float32 cos or sin is an ulp
away from the correctly rounded value that `core/geometry.py` takes
(ROADMAP.md queue 3): there the camera is held to an ulp (rtol 2.4e-7)
and the shift, from the first move at such a pose on, to 1e-3.
`camera()` is memoised on the pose. The meter's line is the JAX
package's, string for string, under the same patched clock. Mirrors
tests/test_runtime.py's controller and meter tests."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu import config as jconfig
from opencl_path_tracer_tpu.runtime import controller as jctl
from opencl_path_tracer_tpu.runtime import meter as jmeter
from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.core import geometry
from opencl_path_tracer_tpu_torch.core.geometry import REF_PI
from opencl_path_tracer_tpu_torch.runtime import controller, meter

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

POSES = {
    "cornell": dict(fov=60.0, yaw=0.0, pitch=0.0, shift=(0.0, 0.0, 0.0)),
    "reference": {},   # the config's default: the reference's live pose
    "odd": dict(fov=9.0, yaw=-123.25, pitch=41.5, shift=(1.5, -2.25, 3.0)),
}

SCRIPTS = {
    "fly": [("down", "w"), ("update", 0.1), ("down", "d"), ("update", 0.05),
            ("up", "w"), ("update", 1 / 60), ("down", "Q"), ("down", "a"),
            ("update", 0.3), ("up", "q"), ("up", "a"), ("up", "d"),
            ("down", "y"), ("down", "s"), ("update", 0.017), ("up", "y"),
            ("up", "s"), ("update", 0.02)],
    "look": [("button", True, 10, 10), ("motion", 20, 10),
             ("motion", 13, -7), ("update", 0.016), ("button", False, 13, -7),
             ("motion", 40, 40), ("down", "w"), ("update", 0.25)],
    "zoom": [("down", "e")] + [("update", 0.45)] * 14 + [
        ("up", "e"), ("button", True, 0, 0), ("motion", 3, 4),
        ("motion", 50, -20), ("down", "c")] + [("update", 0.7)] * 10 + [
        ("up", "c"), ("down", "w"), ("update", 0.1)],
    "keys": [("down", "-"), ("down", "-"), ("down", "-"), ("down", "+"),
             ("down", "r"), ("down", " "), ("down", "space"), ("down", "x"),
             ("down", "Escape"), ("update", 0.1)] + [("down", "+")] * 60,
}


def _pair(pose):
    cam = POSES[pose]
    cfg = RenderConfig(width=24, height=16, iterations=3,
                       camera=CameraConfig(**cam))
    jcfg = jconfig.RenderConfig(width=24, height=16, iterations=3,
                                camera=jconfig.CameraConfig(**cam))
    return jctl.CameraController(jcfg), controller.CameraController(
        cfg, device="cpu")


def _apply(ctl, ev):
    kind = ev[0]
    if kind == "down":
        ctl.key_down(ev[1])
    elif kind == "up":
        ctl.key_up(ev[1])
    elif kind == "button":
        ctl.mouse_button(*ev[1:])
    elif kind == "motion":
        ctl.mouse_motion(*ev[1:])
    else:
        ctl.update(ev[1])


def _trig_agrees(deg) -> bool:
    """True when XLA's float32 cos and sin of the angle are the correctly
    rounded values that core/geometry.py takes (at about 1.4 % of angles
    they are an ulp away)."""
    a = jnp.asarray(deg, jnp.float32) / 180.0 * REF_PI
    c, s = geometry._cos_sin(deg)
    return float(jnp.cos(a)) == float(c) and float(jnp.sin(a)) == float(s)


def _assert_same(p, j, what, exact_shift):
    """State fields bit-equal; the camera bit-equal where XLA's trig of
    the pose's yaw and pitch agrees with the port's, else within an ulp;
    the shift bit-equal while every move so far had agreeing trig."""
    for f in ("fov", "yaw", "pitch", "iterations", "real_time",
              "accumulation_reset", "quit_requested", "fullscreen"):
        assert getattr(p.state, f) == getattr(j.state, f), (what, f)
    assert p.state.shift.dtype == np.float64
    if exact_shift:
        np.testing.assert_array_equal(p.state.shift, j.state.shift,
                                      err_msg=what)
    else:
        np.testing.assert_allclose(p.state.shift, j.state.shift, rtol=0,
                                   atol=1e-3, err_msg=what)
    pc, jc = p.camera(24, 16), j.camera(24, 16)
    exact = _trig_agrees(p.state.yaw) and _trig_agrees(p.state.pitch)
    for f in ("eye", "lookat", "up", "right"):
        a, b = getattr(pc, f).numpy(), np.asarray(getattr(jc, f))
        if exact and exact_shift:
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {f}")
        else:
            np.testing.assert_allclose(a, b, rtol=2.4e-7, atol=1e-3,
                                       err_msg=f"{what}: {f}")
    assert (pc.xm, pc.ym) == (float(jc.xm), float(jc.ym))
    return exact


@pytest.mark.parametrize("pose", list(POSES))
@pytest.mark.parametrize("script", list(SCRIPTS))
def test_controller_sequences_equal_jax(pose, script):
    j, p = _pair(pose)
    exact_shift, n_exact = True, 0
    for i, ev in enumerate(SCRIPTS[script]):
        _apply(j, ev)
        if ev[0] == "update" and p._keys_down & set("wasdqy"):
            exact_shift &= _trig_agrees(p.state.yaw) and _trig_agrees(
                p.state.pitch)
        _apply(p, ev)
        n_exact += _assert_same(p, j, f"{script} event {i} {ev}",
                                exact_shift)
        if i % 3 == 2:
            assert p.consume_reset() == j.consume_reset()
    # Most poses of the scripts are bit-equal.
    assert n_exact >= 0.6 * len(SCRIPTS[script])
    assert not np.array_equal(p.state.shift,
                              np.asarray(POSES[pose].get(
                                  "shift", CameraConfig().shift))) or \
        script == "keys"


def test_controller_semantics():
    """tests/test_runtime.py::test_controller_semantics in the port."""
    _, ctl = _pair("cornell")
    st = ctl.state
    ctl.key_down("-")
    ctl.key_down("-")
    assert st.iterations == 1
    ctl.key_down("-")
    assert st.iterations == 1
    for _ in range(100):
        ctl.key_down("+")
    assert st.iterations == 50
    assert st.real_time
    ctl.key_down("r")
    assert not st.real_time
    ctl.consume_reset()
    ctl.key_down("w")
    ctl.update(0.1)
    assert ctl.consume_reset()
    np.testing.assert_allclose(st.shift, [0.0, 0.0, 100.0], atol=1e-4)
    ctl.key_up("w")
    ctl.mouse_button(True, 10, 10)
    ctl.mouse_motion(20, 10)
    assert abs(st.yaw - 2.0) < 1e-6
    f0 = st.fov
    ctl.key_down("e")
    ctl.update(0.5)
    assert st.fov < f0


def test_controller_esc_and_space():
    """ESC asks to quit; space toggles full screen without a reset."""
    _, ctl = _pair("cornell")
    ctl.consume_reset()
    ctl.key_down(" ")
    assert ctl.state.fullscreen and not ctl.consume_reset()
    ctl.key_down("space")
    assert not ctl.state.fullscreen and not ctl.state.quit_requested
    ctl.key_down("Escape")
    assert ctl.state.quit_requested


def test_camera_memoised_on_pose():
    """An idle pose returns the same tensors; a moved one new ones."""
    _, ctl = _pair("cornell")
    cam = ctl.camera(24, 16)
    ctl.update(0.1)                 # nothing held: the pose holds
    assert ctl.camera(24, 16) is cam
    assert ctl.camera(12, 8) is not cam
    cam = ctl.camera(24, 16)
    ctl.key_down("w")
    ctl.update(0.1)
    moved = ctl.camera(24, 16)
    assert moved is not cam and not torch.equal(moved.eye, cam.eye)
    assert moved.eye.device.type == "cpu"


class _Clock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


@pytest.mark.parametrize("rays", [0.0, 1.5e6, 123456789.0])
def test_meter_line_equals_jax(monkeypatch, rays):
    clock = _Clock(1000.0)
    monkeypatch.setattr(jmeter.time, "monotonic", clock)
    monkeypatch.setattr(meter.time, "monotonic", clock)
    jbuf, pbuf = io.StringIO(), io.StringIO()
    jm, pm = jmeter.PerfMeter(stream=jbuf), meter.PerfMeter(stream=pbuf)
    ticks = [(0.5, 1), (1.25, 3), (1.75, 3), (3.0, 7), (3.0001, 8),
             (9.5, 20)]
    for dt, sample in ticks:
        clock.t = 1000.0 + dt
        kw = dict(iterations=sample % 5 + 1, real_time=bool(sample % 2),
                  rays_traced=rays * sample)
        assert pm.tick(sample, **kw) == jm.tick(sample, **kw)
        assert pbuf.getvalue() == jbuf.getvalue()
        assert (pm.last_samples_per_sec, pm.last_mrays_per_sec) == (
            jm.last_samples_per_sec, jm.last_mrays_per_sec)
    assert pbuf.getvalue().count("\r") == 3
    assert ("Mrays/sec" in pbuf.getvalue()) == bool(rays)


def test_meter_prints_at_interval():
    buf = io.StringIO()
    m = meter.PerfMeter(interval=0.0, stream=buf)
    assert m.tick(10, iterations=2, rays_traced=1e6)
    line = buf.getvalue()
    assert "Samples/sec" in line and "Mrays/sec" in line
    assert not meter.PerfMeter(interval=1e9, stream=buf).tick(5)
