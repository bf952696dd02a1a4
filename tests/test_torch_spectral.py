"""Spectral dispersion in the port (`models/spectral.py`, `ptx-torch
render --dispersion`) against the JAX package's `models/spectral.py` on
the CPU.

- `abbe_ior`, `band_centers`, `band_weights` and `dispersive_materials`
  are bit-equal to JAX's; v_d=None or inf returns the materials object
  itself.
- `render_dispersive` against JAX's run op by op (`jax.disable_jit()`:
  XLA's jit contracts the wavefront step's fold and `_luminance` into
  FMAs, and the JAX package's own band sum then runs in float32 where op
  by op it runs in float64; the port's module docstring). As in
  tests/test_torch_adaptive.py, JAX's XLA `first_intersect` against the
  port's plain one ('bruteforce'), on the triangle Cornell box with its
  glass sphere, at 2 bounces: 3 bands and 5 (weights other than 0 and 1)
  in parity mode, NEE in parity and fast mode (the port's shadow rays
  through the any-hit test and through the intersector, JAX's through
  its nearest hit: the same bits), and the textured room with a glass
  sphere. Each band image is bit-equal to JAX's but for at most OUTLIERS
  of the values, all within RTOL_STEP: the glass, NEE's pow and sqrt
  and fast mode's hemisphere cos and sin round differently in the two
  libraries (measured, seed 3: 3 of 768 values a band, at most 2.8e-7
  relative; other seeds are bit-equal, as tests/test_torch_adaptive.py
  finds at these depths). Given JAX's band images, the port's sum is
  bit-equal to JAX's.
- Against the jitted JAX renderer, 5 bounces and 4 bands in fast mode:
  within RTOL_JIT. Measured: 36 of 768 values differ, at most 6.0e-7 relative (XLA's FMAs through the glass,
  and the float32 band sum).
- Without a refractive material the bands are alike: v_d=30 equals
  v_d=None, and three bands equal the plain wavefront render.
- The CLI renders, refuses what JAX's refuses, and diverges from it on
  purpose twice (ADVICE.md, ROADMAP.md queue 3): it validates the config
  first, so --qmc with --mode parity is refused as on the normal path
  (JAX renders, ignoring --qmc), and it refuses --dispersion <= 0 (JAX
  renders black through NaN), as `abbe_ior` refuses v_d <= 0."""

import os

import jax
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.models import spectral as jspec
from opencl_path_tracer_tpu.models import wavefront as jwf
from opencl_path_tracer_tpu.ops import nee as jnee
from opencl_path_tracer_tpu.runtime import engine as jengine
from opencl_path_tracer_tpu.scene import builder as jbuilder
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import cli
from opencl_path_tracer_tpu_torch.models import spectral, wavefront
from opencl_path_tracer_tpu_torch.ops import nee, rng
from opencl_path_tracer_tpu_torch.ops.kernels.tilecull_kernel import (
    make_scene_occluded,
)
from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
from opencl_path_tracer_tpu_torch.scene import builder, library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

W = H = 16
RTOL_JIT = 2e-6
RTOL_STEP, OUTLIERS = 1e-6, 0.01


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def test_band_tables_equal_jax():
    lam = np.linspace(380.0, 780.0, 401).astype(np.float32)
    for v_d in (20.0, 30.0, 55.0, 64.17):
        np.testing.assert_array_equal(
            _bits(spectral.abbe_ior(1.5168, lam, v_d)),
            _bits(jspec.abbe_ior(1.5168, lam, v_d)))
        n = np.random.default_rng(int(v_d)).uniform(1.2, 2.4, 300).astype(
            np.float32)
        for w in (440.0, 549.0, 612.0, 656.27):
            np.testing.assert_array_equal(
                _bits(spectral.abbe_ior(torch.from_numpy(n), w, v_d)),
                _bits(jspec.abbe_ior(jax.numpy.asarray(n), w, v_d)))
    for bands in range(1, 8):
        np.testing.assert_array_equal(spectral.band_centers(bands),
                                      jspec.band_centers(bands))
        w = spectral.band_weights(bands)
        assert w.dtype == np.float32
        np.testing.assert_array_equal(w, jspec.band_weights(bands))
    js = jlib.cornell_box(with_spheres=True, analytic_spheres=True)
    ps = library.cornell_box(with_spheres=True, analytic_spheres=True)
    assert int((ps.mats.type == 2).sum()) == 1
    for c in np.concatenate([spectral.band_centers(b) for b in (1, 3, 5)]):
        jm = jspec.dispersive_materials(js.mats, c, 30.0)
        pm = spectral.dispersive_materials(ps.mats, c, 30.0)
        np.testing.assert_array_equal(_bits(pm.n), _bits(jm.n))
        for a, b in zip(pm.f0, jm.f0):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        assert pm.kd is ps.mats.kd and pm.type is ps.mats.type
    assert not torch.equal(pm.n, ps.mats.n)
    for v_d in (None, float("inf")):
        assert spectral.dispersive_materials(ps.mats, 500.0, v_d) is ps.mats
        assert spectral.abbe_ior(1.5, 500.0, v_d) == 1.5
    with pytest.raises(ValueError, match="bands must be >= 1"):
        spectral.band_centers(0)


@pytest.mark.parametrize("v_d", [0.0, -30.0])
def test_abbe_ior_refuses_nonpositive_v_d(v_d):
    """A divergence on purpose: JAX's glass index is NaN at v_d = 0, and
    at v_d < 0 blue light bends less than the d line (reversed
    dispersion)."""
    with pytest.raises(ValueError, match="must be > 0"):
        spectral.abbe_ior(1.5, 500.0, v_d)
    mats = library.cornell_box().mats
    with pytest.raises(ValueError, match="must be > 0"):
        spectral.dispersive_materials(mats, 500.0, v_d)
    jm = jspec.dispersive_materials(jlib.cornell_box().mats, 440.0, v_d)
    glass = np.asarray(jm.type) == 2
    n, n_d = np.asarray(jm.n)[glass], mats.n.numpy()[glass]
    assert (np.isnan(n) if v_d == 0.0 else n < n_d).all()


def _glass_room(b, room_path):
    """The textured room with a tessellated glass sphere (material 4)."""
    b.add_obj(room_path, (0, 0, 0), (1, 1, 1))
    glass = b.add_material((0, 0, 0), (0, 0, 0), (0, 0, 0),
                           (1.5, 1.5, 1.5), (0, 0, 0), 50.0, 2)
    for t in library.sphere_mesh((500.0, 400.0, 0.0), 220.0):
        b.add_triangle(t[0], t[1], t[2], glass)
    return b.build()


def _scenes(kind, tmp_path):
    if kind == "room":
        path = library.write_textured_room(str(tmp_path))
        return (_glass_room(jbuilder.SceneBuilder(), path),
                _glass_room(builder.SceneBuilder(), path))
    return jlib.cornell_box(with_spheres=True), library.cornell_box(
        with_spheres=True)


@pytest.mark.parametrize("kind,mode,iters,bands,opt", [
    ("cornell", "parity", 2, 3, "nee-anyhit"),
    ("cornell", "fast", 2, 2, "nee"),
    ("cornell", "parity", 2, 5, ""),
    ("room", "parity", 2, 3, "textured")])
def test_render_dispersive_equals_jax_op_by_op(kind, mode, iters, bands, opt,
                                              tmp_path, monkeypatch):
    js, ps = _scenes(kind, tmp_path)
    textured = opt == "textured"
    jfn = jengine.make_intersect_fn(js, "bruteforce", textured=textured)
    pfn = make_intersect_fn(ps, "bruteforce", textured=textured)
    kw = dict(num_pixels=W * H, iterations=iters, min_spp=2, bands=bands,
              v_d=30.0, mode=mode, seed=3)
    jkw, pkw = dict(kw), dict(kw)
    if opt.startswith("nee"):
        jkw["nee"] = jnee.build_emitter_table(js.tris, js.mats, js.spheres)
        pkw["nee"] = nee.build_emitter_table(ps.tris, ps.mats, ps.spheres)
        if opt == "nee-anyhit":
            pkw["occluded_fn"] = make_scene_occluded(ps)
    # Each package's band images, in band order; the port's render
    # combines JAX's, so its sum is held to JAX's bit for bit whatever
    # the steps' ulps.
    jimgs, pimgs = [], []
    jcolors, pcolors = jwf.colors_by_pixel, wavefront.colors_by_pixel
    monkeypatch.setattr(jwf, "colors_by_pixel", lambda *a: jimgs.append(
        jcolors(*a)) or jimgs[-1])
    monkeypatch.setattr(wavefront, "colors_by_pixel", lambda *a: pimgs.append(
        pcolors(*a)) or torch.from_numpy(np.array(jimgs[len(pimgs) - 1])))
    with jax.disable_jit():
        ref = np.asarray(jspec.render_dispersive(
            jlib.cornell_camera(W, H), js.mats, intersect_fn=jfn, **jkw))
    got = spectral.render_dispersive(library.cornell_camera(W, H), ps.mats,
                                     intersect_fn=pfn, **pkw)
    assert got.dtype == torch.float32 and got.shape == (W * H, 3)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert len(pimgs) == len(jimgs) == bands
    for b, (p, j) in enumerate(zip(pimgs, jimgs)):
        p, j = p.numpy(), np.asarray(j)
        assert (p != j).mean() <= OUTLIERS, f"band {b}"
        np.testing.assert_allclose(p, j, rtol=RTOL_STEP, atol=0.0,
                                   err_msg=f"band {b}")
    assert got.max() > 0.0


def test_render_dispersive_near_jitted_jax():
    js, ps = _scenes("cornell", None)
    kw = dict(num_pixels=W * H, iterations=5, min_spp=2, bands=4, v_d=30.0,
              mode="fast", seed=1)
    ref = np.asarray(jspec.render_dispersive(
        jlib.cornell_camera(W, H), js.mats,
        intersect_fn=jengine.make_intersect_fn(js, "bruteforce"), **kw))
    fn = make_intersect_fn(ps, "bruteforce")
    got = spectral.render_dispersive(library.cornell_camera(W, H), ps.mats,
                                     intersect_fn=fn, **kw).numpy()
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)
    print(f"against jitted JAX: {int((got != ref).sum())} of {got.size} "
          f"values differ, at most {rel.max():.3g} relative")
    np.testing.assert_allclose(got, ref, rtol=RTOL_JIT, atol=0.0)
    assert (got != ref).any() and got.max() > 0.0


def test_no_glass_is_the_plain_render():
    """No refractive material: every band is the plain render, so three
    bands at v_d=30 equal v_d=None and the wavefront render by pixel,
    and five bands equal it within 1e-6 (their float32 weights sum to 1
    within rounding)."""
    ps = library.cornell_box(with_spheres=False)
    cam = library.cornell_camera(W, H)
    fn = make_intersect_fn(ps, "bruteforce")
    tab = nee.build_emitter_table(ps.tris, ps.mats, ps.spheres)
    kw = dict(num_pixels=W * H, iterations=3, min_spp=2, mode="fast",
              nee=tab)
    st = wavefront.render_wavefront(cam, ps.mats, intersect_fn=fn,
                                    exact_spp=True, key=rng.key(1),
                                    device="cpu", **kw)
    plain = wavefront.colors_by_pixel(st, W * H)
    a = spectral.render_dispersive(cam, ps.mats, intersect_fn=fn, bands=3,
                                   v_d=30.0, **kw)
    b = spectral.render_dispersive(cam, ps.mats, intersect_fn=fn, bands=3,
                                   v_d=None, **kw)
    assert torch.equal(a, b) and torch.equal(a, plain)
    c = spectral.render_dispersive(cam, ps.mats, intersect_fn=fn, bands=5,
                                   v_d=30.0, **kw)
    torch.testing.assert_close(c, plain, rtol=1e-6, atol=0.0)
    assert plain.max() > 0.0


def _cli(tmp_path, *extra, out="d.png"):
    return cli.main(["render", "--scene", "cornell", "--size", "12x12",
                     "--spp", "1", "--iters", "2", "--model", "wavefront",
                     "--device", "cpu", "--out", str(tmp_path / out),
                     *extra])


def test_cli_renders_dispersion(tmp_path, capsys):
    assert _cli(tmp_path, "--dispersion", "30", "--bands", "1") == 0
    assert (tmp_path / "d.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    err = capsys.readouterr().err
    assert "1-band dispersive render (V_d=30, accel minarg)" in err
    assert _cli(tmp_path, "--dispersion", "30", "--bands", "2", "--nee",
                "--accel", "bruteforce", out="d.npy") == 0
    img = np.load(tmp_path / "d.npy")
    ps = library.cornell_box(with_spheres=True)
    ref = spectral.render_dispersive(
        library.cornell_camera(12, 12), ps.mats,
        intersect_fn=make_intersect_fn(ps, "bruteforce"), num_pixels=144,
        iterations=2, min_spp=1, bands=2, v_d=30.0,
        nee=nee.build_emitter_table(ps.tris, ps.mats, ps.spheres),
        occluded_fn=make_scene_occluded(ps))
    np.testing.assert_array_equal(img, ref.numpy().reshape(12, 12, 3)[::-1])


@pytest.mark.parametrize("extra,msg", [
    (("--model", "megakernel"), "needs --model wavefront"),
    (("--adaptive", "0.05"), "--adaptive"),
    (("--median",), "--median"), (("--denoise",), "--denoise"),
    (("--env",), "--env"), (("--envmap", "gradient"), "--envmap"),
    (("--resume", "x.npz"), "--resume"),
    (("--checkpoint", "x.npz"), "--checkpoint"),
    (("--bands", "0"), "--bands must be >= 1"),
    (("--dispersion", "0"), "Abbe number > 0"),
    (("--dispersion", "-5"), "Abbe number > 0")])
def test_cli_refusals(extra, msg, tmp_path):
    args = ["--dispersion", "30", *extra]
    with pytest.raises(SystemExit, match=msg):
        _cli(tmp_path, *args)
    assert not os.path.exists(tmp_path / "d.png")


def test_cli_validates_the_config_first(tmp_path):
    """A divergence on purpose: JAX's `_render_dispersive` never
    validates, so --qmc with --mode parity renders there."""
    with pytest.raises(ValueError, match="qmc needs mode='fast'"):
        _cli(tmp_path, "--dispersion", "30", "--qmc", "--mode", "parity")
