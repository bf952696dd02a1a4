"""The turntable (`runtime/anim.py`, `ptx-torch anim`) in the port against
the JAX package's on the CPU. Mirrors tests/test_anim.py.

The renders run the triangle Cornell box without spheres ('cornell-empty')
at 16 x 16 and 2 bounces, JAX op by op (`jax.disable_jit()`, its XLA
`first_intersect`) against the port's 'bruteforce', as
tests/test_torch_interactive.py does: their uint8 frames are equal.

The poses: `orbit_shift` turns the pose's ahead vector with
`core/geometry.py`'s rotations, whose float32 cos and sin are correctly
rounded; XLA's are an ulp off at about 1.4 % of angles (ROADMAP.md queue
3). Where both packages' trig agrees for the yaw and the pitch the
shifts are bit-equal; elsewhere an ahead component is an ulp (at most
2^-23 of a unit vector) away, so the shift is within radius * 2^-23.
Renders take JAX's poses in both packages."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu import cli as jcli
from opencl_path_tracer_tpu import config as jconfig
from opencl_path_tracer_tpu.runtime import anim as janim
from opencl_path_tracer_tpu.runtime import engine as jengine
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import cli
from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.core import geometry
from opencl_path_tracer_tpu_torch.core.geometry import REF_PI
from opencl_path_tracer_tpu_torch.io.image import read_png
from opencl_path_tracer_tpu_torch.runtime import anim, engine
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

W = H = 16
CAM = dict(fov=60.0, yaw=0.0, pitch=0.0, shift=(0.0, 0.0, 0.0))
CENTER, RADIUS = (500.0, 500.0, 500.0), 2500.0
# The pose sweep: 216 yaws at 2.5 degrees by 7 pitches. XLA's cos or sin
# disagrees with the correctly rounded value for 49 of the 1,512 poses.
YAWS = np.arange(-180.0, 360.0, 2.5)
PITCHES = (-30.0, -7.5, 0.0, 12.0, 20.0, 45.0, 80.0)
TRIG_OFF_POSES = 49
# `render_animation(denoise=True)`: tests/test_torch_denoise.py's bound.
ATROUS_RTOL = 2e-5


def _trig_agrees(deg) -> bool:
    """True when XLA's float32 cos and sin of the angle are the correctly
    rounded values that core/geometry.py takes."""
    a = jnp.asarray(deg, jnp.float32) / 180.0 * REF_PI
    c, s = geometry._cos_sin(deg)
    return float(jnp.cos(a)) == float(c) and float(jnp.sin(a)) == float(s)


def test_orbit_shift_equals_jax():
    off = 0
    for pitch in PITCHES:
        for yaw in YAWS:
            got = anim.orbit_shift(CENTER, RADIUS, yaw, pitch)
            ref = janim.orbit_shift(CENTER, RADIUS, yaw, pitch)
            assert got.dtype == np.float64 and got.shape == (3,)
            if _trig_agrees(yaw) and _trig_agrees(pitch):
                np.testing.assert_array_equal(got, ref, err_msg=str(
                    (yaw, pitch)))
            else:
                off += 1
                np.testing.assert_allclose(got, ref, rtol=0,
                                           atol=RADIUS * 2.0 ** -23)
    assert off == TRIG_OFF_POSES


def test_orbit_shift_looks_at_center():
    """eye + radius * ahead(yaw, pitch) == center (tests/test_anim.py)."""
    from opencl_path_tracer_tpu_torch.core.camera import BASE_EYE
    from opencl_path_tracer_tpu_torch.core.geometry import rotate_x, rotate_y
    for yaw, pitch in ((0, 0), (45, 12), (180, -30), (300, 80)):
        eye = np.asarray(BASE_EYE, np.float64) + anim.orbit_shift(
            CENTER, 1700.0, yaw, pitch)
        ahead = rotate_y(rotate_x(torch.tensor([0.0, 0.0, 1.0]), pitch),
                         yaw).numpy()
        np.testing.assert_allclose(eye + 1700.0 * ahead, CENTER, atol=1e-3)


@pytest.mark.parametrize("frames,sweep,start", [
    (4, 360.0, 0.0), (36, 360.0, 0.0), (7, -360.0, 15.0), (4, 180.0, 0.0),
    (5, 90.0, -45.0), (1, 180.0, 10.0), (13, 720.0, 2.5)])
def test_turntable_poses_equal_jax(frames, sweep, start):
    """A full turn is end-exclusive, a partial sweep end-inclusive; the
    yaws and pitches equal JAX's, the shifts as in test_orbit_shift."""
    kw = dict(frames=frames, center=CENTER, radius=RADIUS, pitch=12.0,
              start_yaw=start, sweep=sweep)
    got, ref = anim.turntable_poses(**kw), janim.turntable_poses(**kw)
    assert [p[:2] for p in got] == [p[:2] for p in ref]
    for (yaw, pitch, s), (_, _, r) in zip(got, ref):
        if _trig_agrees(yaw) and _trig_agrees(pitch):
            np.testing.assert_array_equal(s, r)
        else:
            np.testing.assert_allclose(s, r, rtol=0, atol=RADIUS * 2.0 ** -23)
    if frames == 4:
        assert [p[0] for p in got] == ([0.0, 90.0, 180.0, 270.0]
                                       if sweep == 360.0
                                       else [0.0, 60.0, 120.0, 180.0])


def _engines(model, mode, **kw):
    js = jlib.cornell_box(with_spheres=False)
    ps = library.cornell_box(with_spheres=False)
    jcfg = jconfig.RenderConfig(width=W, height=H, iterations=2, mode=mode,
                                model=model, accel="bruteforce",
                                env_light=True,
                                camera=jconfig.CameraConfig(**CAM), **kw)
    pcfg = RenderConfig(width=W, height=H, iterations=2, mode=mode,
                        model=model, accel="bruteforce", env_light=True,
                        camera=CameraConfig(**CAM), **kw)
    return (jengine.RenderEngine(js, jcfg),
            engine.RenderEngine(ps, pcfg, device="cpu"))


def _poses(frames=2):
    return janim.turntable_poses(frames=frames, center=CENTER,
                                 radius=RADIUS, pitch=20.0)


@pytest.mark.parametrize("model", ["megakernel", "wavefront"])
@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_render_animation_equals_jax(model, mode, tmp_path):
    """The sky-lit exterior of the box from two orbit poses (yaw 0 and
    180, pitch 20): each pose restarts the accumulation, and the frames
    equal JAX's, uint8 for uint8; the PNGs are written."""
    je, pe = _engines(model, mode)
    poses = _poses()
    with jax.disable_jit():
        ref = janim.render_animation(je, poses, spp=2, progress=False)
    got = anim.render_animation(pe, poses, spp=2, progress=False,
                                out_dir=str(tmp_path))
    assert len(got) == 2
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == np.uint8 and g.shape == (H, W, 3)
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(
            read_png(str(tmp_path / f"frame_{i:04d}.png")), g)
    assert all(f.mean() > 1 for f in got)
    assert not np.array_equal(got[0], got[1])
    assert pe._sample_host == 2


def test_render_animation_denoised_equals_jax(tmp_path):
    """denoise=True: the frames through the à-trous filter, within
    tests/test_torch_denoise.py's ATROUS_RTOL of JAX's in linear light
    (the last pose's image), equal as uint8 on these inputs."""
    je, pe = _engines("megakernel", "fast")
    poses = _poses()
    with jax.disable_jit():
        ref = janim.render_animation(je, poses, spp=1, progress=False,
                                     denoise=True)
        ref_lin = je.denoised_image(apply_tonemap=False)
    got = anim.render_animation(pe, poses, spp=1, progress=False,
                                denoise=True)
    np.testing.assert_allclose(pe.denoised_image(apply_tonemap=False),
                               ref_lin, rtol=ATROUS_RTOL, atol=1e-7)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    plain = anim.render_animation(pe, poses[:1], spp=1, progress=False)
    assert not np.array_equal(plain[0], got[0])


def _ramp_frames():
    """A frame of exactly 256 colours, one of 65,536 (every red-green
    pair: the quantised path) and the first again."""
    rng = np.random.default_rng(0)
    palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    few = palette[np.arange(37 * 53) % 256].reshape(37, 53, 3)
    v = np.arange(256, dtype=np.uint8)
    many = np.zeros((256, 256, 3), np.uint8)
    many[..., 0], many[..., 1] = v[:, None], v[None, :]
    many[..., 2] = v[::-1][:, None]
    return few, many


@pytest.mark.parametrize("fps", [12.0, 25.0, 7.0])
def test_write_gif_raw_decodes_in_pil(tmp_path, fps):
    """PIL reads the raw writer's file: the frame count, loop 0 and the
    delay that PIL's own writer stores; 256-colour frames exactly, others
    within QUANT_MAX_ERR (25; every red and green value appears)."""
    from PIL import Image
    few, many = _ramp_frames()
    many = np.ascontiguousarray(many[:37, :53])   # 1,961 colours
    frames = [few, many, few]
    raw, pil = str(tmp_path / "raw.gif"), str(tmp_path / "pil.gif")
    anim._write_gif_raw(raw, frames, fps=fps)
    anim.write_gif(pil, frames, fps=fps)
    im, ref = Image.open(raw), Image.open(pil)
    assert im.n_frames == 3
    assert im.info["loop"] == ref.info["loop"] == 0
    assert im.info["duration"] == ref.info["duration"] == (
        anim.gif_delay_ms(fps) // 10 * 10)
    for i, f in enumerate(frames):
        im.seek(i)
        got = np.asarray(im.convert("RGB")).astype(int)
        err = int(np.abs(got - f).max())
        if i != 1:
            assert err == 0
        else:
            assert 0 < err <= anim.QUANT_MAX_ERR


def test_write_gif_raw_quantisation_bound(tmp_path):
    """Every channel value through the 252-colour cube: at most 25 in red
    and blue, 21 in green, and the cube's levels themselves exact."""
    from PIL import Image
    _, many = _ramp_frames()
    path = str(tmp_path / "q.gif")
    anim._write_gif_raw(path, [many])
    got = np.asarray(Image.open(path).convert("RGB")).astype(int)
    err = np.abs(got - many).max(axis=(0, 1))
    assert err.tolist() == [25, 21, 25]
    levels = [np.rint(np.arange(n) * 255.0 / (n - 1)) for n in
              anim.QUANT_LEVELS]
    for c in range(3):
        on = np.isin(many[..., c], levels[c])
        assert np.array_equal(got[..., c][on], many[..., c][on])


def test_write_gif_raw_lzw_runs(tmp_path):
    """Frames whose pixel counts fall on and beside the clear-code runs
    (254 literals) decode exactly."""
    from PIL import Image
    rng = np.random.default_rng(3)
    for w, h in ((254, 1), (255, 1), (127, 2), (1, 509), (85, 3)):
        f = rng.integers(0, 4, (h, w, 3), dtype=np.uint8) * 60
        path = str(tmp_path / f"{w}x{h}.gif")
        anim._write_gif_raw(path, [f, f[::-1].copy()])
        im = Image.open(path)
        for i, ref in enumerate((f, f[::-1])):
            im.seek(i)
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")), ref)


def test_write_gif_dispatch_and_empty(tmp_path, monkeypatch):
    """write_gif goes through PIL where it is installed and through the
    raw writer where it is not; both raise on no frames."""
    few, _ = _ramp_frames()
    calls = []
    real = anim._write_gif_raw
    monkeypatch.setattr(anim, "_write_gif_raw",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    anim.write_gif(str(tmp_path / "a.gif"), [few])
    assert calls == [] and os.path.exists(tmp_path / "a.gif")
    monkeypatch.setattr(anim, "_PIL", None)
    anim.write_gif(str(tmp_path / "b.gif"), [few, few], fps=10)
    assert len(calls) == 1 and calls[0][0] == str(tmp_path / "b.gif")
    for writer in (anim.write_gif, real):
        with pytest.raises(ValueError, match="at least one frame"):
            writer(str(tmp_path / "e.gif"), [])
    with pytest.raises(ValueError, match="must all be"):
        real(str(tmp_path / "f.gif"), [few, few[:5]])


# `ptx-torch anim` against `ptx anim` (JAX op by op), both with
# --accel bruteforce: 2 frames at yaw 0 and 180, pitch 12 or -50 (trig
# agrees at these angles, so the poses are bit-equal and the PNGs are
# compared with the JAX CLI's directly).
ANIM = ["anim", "--size", f"{W}x{H}", "--spp", "1", "--frames", "2",
        "--iters", "2", "--accel", "bruteforce"]
CASES = {
    "sky": ["--scene", "cornell-empty", "--env"],
    # Inside the analytic box, 300 from its middle, looking up 50 degrees
    # at the lamp and the dispersive glass sphere.
    "dispersion": ["--scene", "cornell-analytic", "--center", "500", "500",
                   "500", "--radius", "300", "--pitch", "-50",
                   "--dispersion", "20"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_anim_equals_jax(case, tmp_path, capsys):
    args = ANIM + CASES[case]
    with jax.disable_jit():
        assert jcli.main(args + ["--gif", "", "--out-dir",
                                 str(tmp_path / "j")]) == 0
    gif = str(tmp_path / "p.gif")
    assert cli.main(args + ["--device", "cpu", "--gif", gif, "--out-dir",
                            str(tmp_path / "p")]) == 0
    err = capsys.readouterr().err
    assert "2 frames in " in err and f"wrote {gif}" in err
    assert all(_trig_agrees(a) for a in (0.0, 180.0, 12.0, -50.0))
    frames = []
    for i in range(2):
        ref = read_png(str(tmp_path / "j" / f"frame_{i:04d}.png"))
        got = read_png(str(tmp_path / "p" / f"frame_{i:04d}.png"))
        np.testing.assert_array_equal(got, ref)
        assert got.mean() > 1
        frames.append(got)
    from PIL import Image
    im = Image.open(gif)
    assert im.n_frames == (1 if np.array_equal(*frames) else 2)


def test_cli_anim_poses_off_the_trig(tmp_path):
    """Where a pose's yaw is one of XLA's inexact angles (27 degrees: its
    cos or sin is an ulp from the correctly rounded value), the CLI's
    shift is an ulp from JAX's, so its frames are held to the port's own
    render_animation at the CLI's poses, which are JAX's bounds, center
    and radius turned by the port's rotations: a camera an ulp off may
    move a ray across a pixel's rounding, so JAX's frames are no
    reference there."""
    from opencl_path_tracer_tpu.cli import _scene_bounds as jbounds
    yaw = 27.0
    assert not _trig_agrees(yaw)
    assert cli.main(ANIM + ["--scene", "cornell-empty", "--env", "--sweep",
                            str(yaw), "--pitch", "20", "--device", "cpu",
                            "--gif", "", "--out-dir", str(tmp_path)]) == 0
    ps = library.cornell_box(with_spheres=False)
    jlo, jhi = jbounds(jlib.cornell_box(with_spheres=False))
    plo, phi = cli._scene_bounds(ps)
    assert plo.dtype == jlo.dtype == np.float32
    np.testing.assert_array_equal(plo, jlo)
    np.testing.assert_array_equal(phi, jhi)
    kw = dict(frames=2, center=tuple((jlo + jhi) / 2.0),
              radius=1.6 * float(np.linalg.norm(jhi - jlo)) / 2.0,
              pitch=20.0, sweep=yaw)
    mine, ref = anim.turntable_poses(**kw), janim.turntable_poses(**kw)
    np.testing.assert_array_equal(mine[0][2], ref[0][2])
    assert not np.array_equal(mine[1][2], ref[1][2])
    np.testing.assert_allclose(mine[1][2], ref[1][2], rtol=0,
                               atol=kw["radius"] * 2.0 ** -23)
    cfg = RenderConfig(width=W, height=H, iterations=2, accel="bruteforce",
                       env_light=True, camera=CameraConfig(
                           **dict(CAM, pitch=20.0)))
    eng = engine.RenderEngine(ps, cfg, device="cpu")
    frames = anim.render_animation(eng, mine, spp=1, progress=False)
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(
            read_png(str(tmp_path / f"frame_{i:04d}.png")), f)


@pytest.mark.parametrize("extra,msg", [
    (["--denoise"], "does not compose with --denoise"),
    (["--env"], "does not compose with --env"),
    (["--envmap", "sunsky"], "does not compose with --envmap"),
    (["--bands", "0"], "--bands must be >= 1"),
    (["--dispersion", "0"], "Abbe number > 0"),
])
def test_cli_anim_dispersion_refusals(extra, msg, tmp_path):
    args = (ANIM + ["--scene", "cornell-analytic", "--dispersion", "30",
                    "--device", "cpu", "--gif", str(tmp_path / "d.gif")]
            + extra)
    with pytest.raises(SystemExit, match=msg):
        cli.main(args)
    assert not os.path.exists(tmp_path / "d.gif")


def test_cli_anim_dispersion_validates_the_config_first(tmp_path):
    """A divergence on purpose, as `render --dispersion`'s: JAX's
    `_anim_dispersive` never validates, so --qmc with --mode parity
    renders there."""
    with pytest.raises(ValueError, match="qmc needs mode='fast'"):
        cli.main(ANIM + ["--scene", "cornell-analytic", "--dispersion", "30",
                         "--qmc", "--mode", "parity", "--device", "cpu",
                         "--gif", ""])


def test_cli_anim_flags_are_jax_flags():
    """anim's flags and defaults are the JAX CLI's, with --device."""
    def flags(main):
        import argparse
        got = {}
        real = argparse.ArgumentParser.parse_args

        def grab(self, argv=None, ns=None):
            for a in self._actions:
                if isinstance(a, argparse._SubParsersAction):
                    got.update(a.choices)
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = grab
        try:
            main([])
        except SystemExit:
            pass
        finally:
            argparse.ArgumentParser.parse_args = real
        return {name: {a.dest: a.default for a in p._actions}
                for name, p in got.items()}

    mine, ref = flags(cli.main), flags(jcli.main)
    for cmd in ("anim", "view", "serve"):
        assert {k: v for k, v in mine[cmd].items() if k != "device"} == \
            ref[cmd], cmd
        assert mine[cmd]["device"] == "cuda"
    assert mine["anim"]["gif"] == "turntable.gif"
    assert (mine["anim"]["fps"], mine["anim"]["sweep"],
            mine["anim"]["frames"], mine["anim"]["spp"]) == (12.0, 360.0, 36,
                                                             16)
    assert mine["serve"]["port"] == 8642


def test_anim_refuses_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(ANIM + ["--gif", str(tmp_path / "x.gif")])
    assert not os.path.exists(tmp_path / "x.gif")


def test_anim_exits_nonzero_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a GPU: `anim` exits non-zero "
                    "there")
    r = subprocess.run([sys.executable, "-m", "opencl_path_tracer_tpu_torch"
                        ".cli", "anim", "--size", "8x8", "--frames", "1",
                        "--gif", str(tmp_path / "x.gif")],
                       capture_output=True, text=True)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert not os.path.exists(tmp_path / "x.gif")
