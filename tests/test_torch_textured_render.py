"""Textured rendering in the port against the JAX package on the CPU:
`runtime.engine.make_intersect_fn(textured=True)` (the (Hits, kd)
intersector) for the 'bruteforce', 'minarg' and 'tilecull' accels, with
an analytic sphere and with smooth shading; megakernel and wavefront
renders with it, with NEE through the any-hit test and through the
intersector, and with an environment map; `RenderEngine` with
`RenderConfig(textured=True)` against the JAX engine; JAX's three
refusals; and `ptx-torch render --textured`.

The scene is `library.write_textured_room`'s OBJ (two PNG maps, one
missing) loaded by both packages' `SceneBuilder.add_obj`.

Tolerances, measured:
- the intersector is bit-equal to JAX's op by op (`jax.disable_jit()`),
  the JAX side through its interpret-mode kernels and, for the sphere,
  interpret-mode K3b (XLA's `sphere_intersect` rounds otherwise; the
  port's K3 follows K3b), with smooth normals within atol 1e-6 (JAX's
  `smooth_hit_normals` normalises with XLA's approximate rsqrt);
- renders against JAX op by op (`jax.disable_jit()`): bit-equal without
  NEE or an environment map; with them, the goldens' tolerance, RTOL
  1e-4 and ATOL 1e-6 on every value (measured: at most 5.2e-5 relative,
  from NEE's pow and sqrt); the wavefront steps likewise, with ATOL
  1e-4 on the ray origins (coordinates up to 1,500);
- renders against the jitted JAX package (`_close`): RTOL and ATOL on
  all but OUTLIERS (1 %) of the values, and RTOL_OUT 2e-3 on those.
  Measured: the megakernel at most 1.8e-4 relative at 2 of 768 values
  (XLA contracts the bilinear blend and the shading into fused
  multiply-adds; JAX's op-by-op render differs from its jitted one
  there too); the wavefront engine in fast mode, 1.03e-3 at 1 of 768
  values, where JAX op by op and jitted agree. Untextured, the same
  wavefront renders differ from JAX at 27 values by at most 3.6e-7: an
  ulp of the hemisphere sample's cos and sin, which round differently
  in XLA's and PyTorch's libraries. The texture amplifies such an ulp:
  its texels change by up to 0.9 within 1/256 of a UV unit, and a
  bounce that lands an ulp elsewhere samples another blend.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.config import CameraConfig as JCameraConfig
from opencl_path_tracer_tpu.config import RenderConfig as JRenderConfig
from opencl_path_tracer_tpu.core.types import Rays as JRays
from opencl_path_tracer_tpu.models import megakernel as jmk
from opencl_path_tracer_tpu.models import wavefront as jwf
from opencl_path_tracer_tpu.ops import envmap as jenvmap
from opencl_path_tracer_tpu.ops import nee as jnee
from opencl_path_tracer_tpu.ops.pallas.sphere_kernel import (
    make_sphere_table_intersect as jsph,
)
from opencl_path_tracer_tpu.runtime import engine as jengine
from opencl_path_tracer_tpu.scene import builder as jbuilder
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import cli, interop
from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.core.types import Rays
from opencl_path_tracer_tpu_torch.io.image import read_png
from opencl_path_tracer_tpu_torch.models import megakernel, wavefront
from opencl_path_tracer_tpu_torch.ops import envmap, nee, raygen, rng
from opencl_path_tracer_tpu_torch.ops.kernels.tilecull_kernel import (
    make_scene_occluded,
)
from opencl_path_tracer_tpu_torch.runtime.engine import (
    RenderEngine, make_intersect_fn,
)
from opencl_path_tracer_tpu_torch.scene import builder, library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6
OUTLIERS, RTOL_OUT = 0.01, 2e-3
W = H = 16
PRESET = dict(fov=60.0, yaw=0.0, pitch=0.0, shift=(0.0, 0.0, 0.0))


@functools.lru_cache(maxsize=None)
def _room_path(tmp_root):
    return library.write_textured_room(tmp_root)


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    return _room_path(str(tmp_path_factory.mktemp("room")))


def _scenes(path, *, sphere=False, smooth=False):
    """The room through both builders, with ROOM_SPHERE (material 0,
    textured) when asked."""
    out = []
    for b in (jbuilder.SceneBuilder(), builder.SceneBuilder()):
        b.add_obj(path, (0, 0, 0), (1, 1, 1), smooth_normals=smooth)
        if sphere:
            b.add_analytic_sphere(*library.ROOM_SPHERE, 0)
        out.append(b.build())
    return out


@pytest.fixture
def jax_k3b(monkeypatch):
    """The JAX engine's sphere stream through interpret-mode K3b."""
    monkeypatch.setattr(
        jengine, "_make_sphere_fn",
        lambda scene: (None if scene.spheres is None
                       else jsph(scene.spheres, interpret=True)))


def _rays():
    """16x16 camera rays from the Cornell preset's eye, and 256 rays in
    random directions from around the room's middle (first-bounce-like:
    every wall, the sphere and the lamp from all sides)."""
    cam = library.cornell_camera(W, H)
    half = torch.full((W * H,), 0.5)
    cr = raygen.camera_rays(cam, raygen.pixel_ids_like(W * H), half, half)
    rs = np.random.default_rng(1)
    org = np.float32([500, 600, -200]) + rs.normal(0, 100, (256, 3))
    d = rs.normal(size=(256, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org, d = org.astype(np.float32), d.astype(np.float32)
    p = tuple(torch.cat([cr.p[k], torch.from_numpy(org[:, k].copy())])
              for k in range(3))
    dd = tuple(torch.cat([cr.d[k], torch.from_numpy(d[:, k].copy())])
               for k in range(3))
    return Rays(p=p, d=dd), JRays(p=tuple(jnp.asarray(c.numpy()) for c in p),
                                  d=tuple(jnp.asarray(c.numpy()) for c in dd))


@pytest.mark.parametrize("accel", ["bruteforce", "minarg", "tilecull"])
@pytest.mark.parametrize("variant", ["plain", "sphere", "smooth"])
def test_textured_intersector_matches_jax(room, jax_k3b, accel, variant):
    js, ps = _scenes(room, sphere=variant != "plain",
                     smooth=variant == "smooth")
    smooth = variant == "smooth"
    prays, jrays = _rays()
    jfn = jengine.make_intersect_fn(js, accel, textured=True, smooth=smooth)
    with jax.disable_jit():
        jh, jkd = jfn(jrays)
    ph, pkd = make_intersect_fn(ps, accel, textured=True, smooth=smooth)(
        prays)
    np.testing.assert_array_equal(ph.t.numpy(), np.asarray(jh.t))
    np.testing.assert_array_equal(ph.mati.numpy(), np.asarray(jh.mati))
    for k in range(3):
        np.testing.assert_array_equal(ph.p[k].numpy(), np.asarray(jh.p[k]))
        np.testing.assert_array_equal(pkd[k].numpy(), np.asarray(jkd[k]))
        if smooth:
            np.testing.assert_allclose(ph.n[k].numpy(), np.asarray(jh.n[k]),
                                       rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(ph.n[k].numpy(),
                                          np.asarray(jh.n[k]))
    textured = pkd[0] != 1.0
    assert 0.3 < float(textured[:W * H].float().mean()) < 1.0
    if variant != "plain":
        # Sphere winners sample exactly 1.0, though their material
        # ('wall_a') is textured; the sphere is in view.
        (cx, cy, cz), r = library.ROOM_SPHERE
        dist = ((ph.p[0] - cx) ** 2 + (ph.p[1] - cy) ** 2
                + (ph.p[2] - cz) ** 2).sqrt()
        on_sphere = (ph.t > 0) & ((dist - r).abs() < 1e-2 * r)
        assert int(on_sphere.sum()) > 10
        assert all(bool((pkd[k][on_sphere] == 1.0).all()) for k in range(3))


def _close(got, ref):
    """The tolerance against the jitted JAX package (the module
    docstring)."""
    out = ~np.isclose(got, ref, rtol=RTOL, atol=ATOL)
    assert out.mean() <= OUTLIERS, f"{int(out.sum())} of {out.size} values"
    np.testing.assert_allclose(got, ref, rtol=RTOL_OUT, atol=ATOL)


def _render(jfn, pfn, js, ps, *, jit=False, **kw):
    """One 16x16 megakernel render of each package; JAX op by op unless
    jit. kw: iterations, spp, mode, nee (True), occluded (True), env."""
    jkw = dict(num_pixels=W * H, iterations=kw.get("iterations", 3),
               spp=kw.get("spp", 2), mode=kw.get("mode", "parity"))
    pkw = dict(jkw)
    if kw.get("nee"):
        jkw["nee"] = jnee.build_emitter_table(js.tris, js.mats, js.spheres)
        pkw["nee"] = nee.build_emitter_table(ps.tris, ps.mats, ps.spheres)
        if kw.get("occluded"):
            pkw["occluded_fn"] = make_scene_occluded(ps)
    if kw.get("env"):
        jkw["env"] = jenvmap.load_envmap(kw["env"])
        pkw["env"] = envmap.load_envmap(kw["env"])
    cam, jcam = library.cornell_camera(W, H), jlib.cornell_camera(W, H)
    if jit:
        j = jmk.render(jcam, js.mats, intersect_fn=jfn, **jkw)
    else:
        with jax.disable_jit():
            j = jmk.render(jcam, js.mats, intersect_fn=jfn, **jkw)
    p = megakernel.render(cam, ps.mats, intersect_fn=pfn, device="cpu",
                          **pkw)
    np.testing.assert_array_equal(p.rng_state.numpy(),
                                  np.asarray(j.rng_state).astype(np.int64))
    return megakernel.colors_array(p).numpy(), np.asarray(
        jmk.colors_array(j))


@pytest.mark.parametrize("mode,opt,jit", [
    ("parity", "", False), ("parity", "", True),
    ("fast", "nee", False), ("fast", "nee-occluded", False),
    ("parity", "nee-occluded", True)])
def test_megakernel_textured_render_matches_jax(room, mode, opt, jit):
    """NEE's shadow rays through the any-hit test ('occluded') or through
    the (Hits, kd) intersector, whose tuple the gather strips."""
    js, ps = _scenes(room)
    jfn = jengine.make_intersect_fn(js, "bruteforce", textured=True)
    pfn = make_intersect_fn(ps, "bruteforce", textured=True)
    got, ref = _render(jfn, pfn, js, ps, mode=mode, jit=jit,
                       nee="nee" in opt, occluded="occluded" in opt)
    if jit:
        _close(got, ref)
    elif opt:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got, ref)
    plain = megakernel.render(
        library.cornell_camera(W, H), ps.mats,
        intersect_fn=make_intersect_fn(ps, "bruteforce"), num_pixels=W * H,
        iterations=3, spp=2, mode=mode, device="cpu",
        nee=(nee.build_emitter_table(ps.tris, ps.mats, ps.spheres)
             if "nee" in opt else None))
    assert np.abs(megakernel.colors_array(plain).numpy() - got).max() > 1e-3


def _open_floor(b):
    """A textured floor and a lamp under the open sky (an environment map
    lights what escapes), in the Cornell camera's frame."""
    floor = b.add_material((0.8, 0.8, 0.8), (0, 0, 0), (0, 0, 0), (1, 1, 1),
                           (0, 0, 0), 50.0, 0)
    lamp = b.add_material((0, 0, 0), (0, 0, 0), (10.0, 10.0, 10.0),
                          (1, 1, 1), (0, 0, 0), 50.0, 3)
    x0, x1, z0, z1 = -2000.0, 3000.0, -2000.0, 6000.0
    b.add_triangle((x0, 0, z0), (x1, 0, z0), (x1, 0, z1), floor,
                   uv=((0, 0), (6, 0), (6, 9)))
    b.add_triangle((x0, 0, z0), (x1, 0, z1), (x0, 0, z1), floor,
                   uv=((0, 0), (6, 9), (0, 9)))
    b.add_triangle((200, 600, 200), (800, 600, 200), (800, 600, 800), lamp)
    img = np.random.default_rng(5).integers(0, 256, (8, 8, 3), np.uint8)
    b.set_material_texture(floor, b.add_texture(img))
    return b.build()


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_megakernel_textured_envmap_render_matches_jax(mode):
    js = _open_floor(jbuilder.SceneBuilder())
    ps = _open_floor(builder.SceneBuilder())
    jfn = jengine.make_intersect_fn(js, "bruteforce", textured=True)
    pfn = make_intersect_fn(ps, "bruteforce", textured=True)
    got, ref = _render(jfn, pfn, js, ps, mode=mode, env="gradient")
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert got.max() > 0.0


def _to_port(jst):
    return interop.wavefront_state_from_numpy(
        {f: getattr(jst, f) for f in jst.__dataclass_fields__})


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_wavefront_textured_steps_match_jax(room, mode):
    """Five NEE steps (shadow rays through the (Hits, kd) intersector),
    each from JAX's op-by-op state."""
    js, ps = _scenes(room)
    jfn = jengine.make_intersect_fn(js, "bruteforce", textured=True)
    pfn = make_intersect_fn(ps, "bruteforce", textured=True)
    jtab = jnee.build_emitter_table(js.tris, js.mats, js.spheres)
    ptab = nee.build_emitter_table(ps.tris, ps.mats, ps.spheres)
    jcam, pcam = jlib.cornell_camera(W, H), library.cornell_camera(W, H)
    jst = jwf.init_wavefront(jcam, W * H, mode=mode, key=jax.random.key(4))
    for s in range(5):
        pst = wavefront.wavefront_step(
            pcam, ps.mats, _to_port(jst), intersect_fn=pfn, iterations=3,
            mode=mode, key=rng.key(4), nee=ptab)
        with jax.disable_jit():
            jst = jwf.wavefront_step(jcam, js.mats, jst, intersect_fn=jfn,
                                     iterations=3, mode=mode,
                                     key=jax.random.key(4), nee=jtab)
        got = interop.wavefront_state_to_numpy(pst)
        for name in ("colors", "cur_color", "f_l", "ray_p", "ray_d"):
            np.testing.assert_allclose(
                np.stack(got[name]), np.stack([np.asarray(c) for c in
                                               getattr(jst, name)]),
                rtol=RTOL, atol=ATOL * 100 if name == "ray_p" else ATOL,
                err_msg=f"step {s}: {name}")
        for name in ("samples", "bounce", "rng_state"):
            np.testing.assert_array_equal(
                got[name].astype(np.int64),
                np.asarray(getattr(jst, name)).astype(np.int64),
                err_msg=f"step {s}: {name}")
    assert int(jnp.sum(jst.samples)) > 0


def _cfg(cls, cam_cls, **kw):
    return cls(width=W, height=H, iterations=3, spp=2, mode="fast",
               accel="bruteforce", camera=cam_cls(**PRESET), **kw)


@pytest.mark.parametrize("model", ["megakernel", "wavefront"])
def test_engine_textured_matches_jitted_jax_engine(room, model):
    """RenderConfig(textured=True) validates and renders in both models
    within the renders' tolerance of the jitted JAX engine; the textured
    image differs from the untextured one."""
    js, ps = _scenes(room)
    je = jengine.RenderEngine(js, _cfg(JRenderConfig, JCameraConfig,
                                       textured=True, model=model))
    je.render(2, progress=False)
    pe = RenderEngine(ps, _cfg(RenderConfig, CameraConfig, textured=True,
                               model=model), device="cpu")
    pe.render(2, progress=False)
    got = pe.image(apply_tonemap=False)
    _close(got, je.image(apply_tonemap=False))
    flat = RenderEngine(ps, _cfg(RenderConfig, CameraConfig, model=model),
                        device="cpu")
    flat.render(2, progress=False)
    assert np.abs(flat.image(apply_tonemap=False) - got).max() > 1e-3
    assert np.isfinite(got).all()


def test_engine_textured_sphere_and_smooth_render(room):
    """The sphere merged after the ids stream and smooth normals, through
    the engine's 'auto' (minarg with ids) in both models."""
    _, ps = _scenes(room, sphere=True, smooth=True)
    imgs = []
    for model in ("megakernel", "wavefront"):
        e = RenderEngine(ps, dataclasses.replace(
            _cfg(RenderConfig, CameraConfig, textured=True, smooth=True,
                 nee=True, model=model), accel="auto"), device="cpu")
        e.render(2, progress=False)
        imgs.append(e.image(apply_tonemap=False))
        assert np.isfinite(imgs[-1]).all() and imgs[-1].max() > 0.0
    assert not np.array_equal(imgs[0], imgs[1])


@pytest.mark.parametrize("case", ["no textures", "no uv", "not ids"])
def test_refusals_match_jax(room, case):
    js, ps = _scenes(room)
    accel = "bruteforce"
    if case == "no textures":
        js, ps = (jlib.cornell_box(with_spheres=True),
                  library.cornell_box(with_spheres=True))
        match = "no textures"
    elif case == "no uv":
        for s in (js, ps):
            object.__setattr__(s, "attribs", None)
        match = "per-corner UVs"
    else:
        accel, match = "pallas", "ids-reporting"
    with pytest.raises(ValueError, match=match):
        jengine.make_intersect_fn(js, accel, textured=True)
    with pytest.raises(ValueError, match=match):
        make_intersect_fn(ps, accel, textured=True)


@pytest.mark.parametrize("accel", ["pair", "cluster", "march"])
def test_refuses_other_accels(room, accel):
    _, ps = _scenes(room)
    with pytest.raises(ValueError, match="ids-reporting"):
        make_intersect_fn(ps, accel, textured=True)


def test_auto_resolves_with_the_ids_cap(room, tmp_path):
    """'auto' takes minarg up to 4,096 triangles and pairwin above for a
    textured scene (JAX's cut for its ids path); the grid room (8,206
    triangles) resolves to pairwin, whose plain versions run here."""
    from opencl_path_tracer_tpu_torch.runtime import engine
    assert engine.resolve_accel("auto", 4096, True, True) == "minarg"
    assert engine.resolve_accel("auto", 8206, True, True) == "pairwin"
    grid = library.textured_room(str(tmp_path), grid=True)
    prays, _ = _rays()
    hits, kd = make_intersect_fn(grid, textured=True)(prays)
    ref, rkd = make_intersect_fn(grid, "bruteforce", textured=True)(prays)
    assert torch.equal(hits.t, ref.t)
    for k in range(3):
        assert torch.equal(kd[k], rkd[k])


@pytest.mark.parametrize("extra", [[], ["--model", "wavefront", "--nee"],
                                   ["--accel", "tilecull", "--smooth"]])
def test_cli_render_textured(room, extra, tmp_path, capsys):
    out = tmp_path / "t.png"
    assert cli.main(["render", "--scene", room, "--textured", "--size",
                     "16x12", "--spp", "2", "--iters", "2", "--device",
                     "cpu", "--out", str(out)] + extra) == 0
    err = capsys.readouterr().err
    assert "'missing.png': not found" in err and "on cpu" in err
    img = read_png(str(out))
    assert img.shape == (12, 16, 3) and img.max() > 0
    flat = tmp_path / "f.png"
    assert cli.main(["render", "--scene", room, "--size", "16x12", "--spp",
                     "2", "--iters", "2", "--device", "cpu", "--out",
                     str(flat)] + extra) == 0
    assert not np.array_equal(read_png(str(flat)), img)
