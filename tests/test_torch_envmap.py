"""The environment map (`ops/envmap.py`) in the port against the JAX
package's on the CPU.

`build_envmap`, `gradient_sky`, `sun_sky` and the loaders are host numpy
and bit-equal. `sample_envmap`'s texel is the JAX package's compare-count
exactly (`torch.searchsorted`, side 'left'), ties with the cumulative
table and u1 = 1.0 and 0.0 included. The device lookups are the same
IEEE operations in the same order but for arccos, arctan2, cos, sin and
pow, which round an ulp apart in XLA's and PyTorch's CPU libraries
(eager JAX, op by op): on 20,000 draws of the procedural maps the
sampled directions differ at about 6 % of the lanes by at most 6e-7
(atol 1e-6 here, none beyond), the pdfs at about 10 % by at most 4.2e-6
relative (rtol 1e-5, none beyond) and the solid-angle pdf by at most
7e-8 (atol 1e-6 of the largest pdf, none beyond). The bilinear radiance
takes the ulp of x = u Wi (up to 256) into its weights, which the sun's
4,000 : 0.1 rim turns into up to 0.061 (249 of 60,000 values of the
sun-sky map beyond rtol 2e-5 alone; rtol 2e-5 with atol 3e-5 of the
map's brightest texel, none beyond). The gather (`direct_light_env`, through
`make_scene_occluded` against JAX's interpret-mode one, and through the
intersector, K1 + K2 + K3 against interpret-mode K1 + K2 + K3b), `envmap_miss_update` and whole 8 x 8 renders of both
models hold to the NEE tests' rtol 1e-4 / atol 5e-5 (renders: at most
2.9e-6 relative measured, at up to 18 of 192 values at 5 bounces).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.io import image as jimage
from opencl_path_tracer_tpu.models import megakernel as jmk
from opencl_path_tracer_tpu.models import wavefront as jwf
from opencl_path_tracer_tpu.ops import envmap as je
from opencl_path_tracer_tpu.ops import intersect as jisect
from opencl_path_tracer_tpu.ops.pallas.plucker_kernel import (
    make_minarg_intersect as jminarg,
)
from opencl_path_tracer_tpu.ops.pallas.sphere_kernel import (
    make_sphere_table_intersect as jsph,
)
from opencl_path_tracer_tpu.ops.pallas.tilecull_kernel import (
    make_scene_occluded as jocc,
)
from opencl_path_tracer_tpu.scene import builder as jbuilder
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import interop
from opencl_path_tracer_tpu_torch.core.types import vdot, vneg, vwhere
from opencl_path_tracer_tpu_torch.io import image
from opencl_path_tracer_tpu_torch.models import megakernel, wavefront
from opencl_path_tracer_tpu_torch.ops import envmap, raygen, rng
from opencl_path_tracer_tpu_torch.ops.kernels.tilecull_kernel import (
    make_scene_occluded,
)
from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
from opencl_path_tracer_tpu_torch.scene import builder, library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 5e-5      # the gather, the pickup, the renders
W = H = 8


def _np(x):
    if isinstance(x, tuple):
        return np.stack([_np(c) for c in x])
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _j(x):
    if isinstance(x, tuple):
        return tuple(_j(c) for c in x)
    return jnp.asarray(x.numpy())


def _t(x):
    if isinstance(x, tuple):
        return tuple(_t(c) for c in x)
    return torch.from_numpy(np.array(x))


def _maps(name, nee=True):
    return je.load_envmap(name, nee=nee), envmap.load_envmap(name, nee=nee)


@pytest.mark.parametrize("sky", ["gradient", "sunsky"])
@pytest.mark.parametrize("res", [(64, 32), (16, 8), (1000, 1000), (7, 5)])
def test_build_envmap_bit_equal(sky, res):
    img = je.gradient_sky() if sky == "gradient" else je.sun_sky()
    mine = envmap.gradient_sky() if sky == "gradient" else envmap.sun_sky()
    np.testing.assert_array_equal(mine, img)
    a = je.build_envmap(img, sample_res=res, scale=2.5, nee=False)
    b = envmap.build_envmap(img, sample_res=res, scale=2.5, nee=False)
    for f in ("img", "prob", "cum"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)), err_msg=f)
    assert (b.Wi, b.Hi, b.Ws, b.Hs, b.nee) == (a.Wi, a.Hi, a.Ws, a.Hs, a.nee)
    assert b.cum[-1] == 1.0


def test_load_envmap_from_files_and_errors(tmp_path):
    rs = np.random.default_rng(4)
    img = rs.uniform(0.0, 3.0, (6, 10, 3)).astype(np.float32)
    pfm, png, npy = (str(tmp_path / f"e.{x}") for x in ("pfm", "png", "npy"))
    image.write_pfm(pfm, img)
    image.write_png(png, np.clip(img / 3.0, 0.0, 1.0))
    np.save(npy, img)
    for path in (pfm, png):
        a = je.load_envmap(path, sample_res=(4, 3))
        b = envmap.load_envmap(path, sample_res=(4, 3))
        for f in ("img", "prob", "cum"):
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          np.asarray(getattr(a, f)))
    # sRGB decode of the PNG, and .npy as linear radiance.
    np.testing.assert_array_equal(
        envmap.load_envmap(png, srgb=False).img.numpy()[:, :3],
        (jimage.read_png(png).reshape(-1, 3) / 255.0).astype(np.float32))
    np.testing.assert_array_equal(
        envmap.load_envmap(npy).img.numpy(),
        envmap.build_envmap(img).img.numpy())
    with pytest.raises(ValueError, match="expected"):
        envmap.load_envmap("sky.hdr")
    with pytest.raises(ValueError, match="black"):
        envmap.build_envmap(np.zeros((4, 8, 3)))
    with pytest.raises(ValueError, match=">= 0"):
        envmap.build_envmap(-np.ones((4, 8, 3)))
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        envmap.build_envmap(np.ones((4, 8)))


def _uniforms(em, n, seed):
    """(3, n) float32 uniforms; u1 also takes every 97th lane from the
    cumulative table itself (ties), and 0.0 and 1.0."""
    rs = np.random.default_rng(seed)
    u = rs.random((3, n)).astype(np.float32)
    cum = em.cum.numpy()
    u[0, ::97] = cum[rs.integers(0, cum.shape[0], u[0, ::97].shape[0])]
    u[0, 1], u[0, 2] = 0.0, 1.0
    return u


@pytest.mark.parametrize("sky", ["gradient", "sunsky"])
def test_sample_envmap_index_exact_and_direction_close(sky):
    a, b = _maps(sky)
    u = _uniforms(b, 20000, 1)
    # The index: the JAX package's compare-count, exactly.
    count = np.sum(np.asarray(a.cum)[None, :] < u[0][:, None], axis=1)
    idx = torch.searchsorted(b.cum, torch.from_numpy(u[0]), side="left")
    np.testing.assert_array_equal(idx.numpy(), count)
    assert (u[0][:, None] == b.cum.numpy()[None, :]).any(1).sum() > 100
    with jax.disable_jit():
        jd, jp = je.sample_envmap(a, *_j(_t(tuple(u))))
    pd, pp = envmap.sample_envmap(b, *_t(tuple(u)))
    np.testing.assert_allclose(_np(pd), _np(jd), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=1e-5)
    # Same texel: the row of the sampled direction, and pdf > 0 there.
    assert (pp.numpy() > 0).all()


@pytest.mark.parametrize("sky", ["gradient", "sunsky"])
def test_env_radiance_and_pdf_close(sky):
    a, b = _maps(sky)
    rs = np.random.default_rng(2)
    v = rs.normal(size=(3, 20000))
    v = (v / np.linalg.norm(v, axis=0)).astype(np.float32)
    sampled, _ = envmap.sample_envmap(b, *_t(tuple(_uniforms(b, 20000, 3))))
    # The poles and the seam: phi = +-pi, theta = 0 and pi.
    special = np.array([[0, 1, 0], [0, -1, 0], [-1, 0, 0], [-1, 0, -0.0],
                        [1, 0, 0], [0, 0, 1]], np.float32).T
    for dirs in (tuple(v), tuple(_np(sampled)), tuple(special)):
        with jax.disable_jit():
            jr = je.env_radiance(a, _j(_t(dirs)))
            jps = je.env_pdf_sa(a, _j(_t(dirs)))
        pr = envmap.env_radiance(b, _t(dirs))
        pps = envmap.env_pdf_sa(b, _t(dirs))
        # An ulp of x = u Wi (up to 256) in the bilinear weights, times
        # the map's contrast: up to 0.061 on the sun's 4,000 : 0.1 rim.
        atol = 3e-5 * float(b.img.max())
        np.testing.assert_allclose(_np(pr), _np(jr), rtol=2e-5, atol=atol)
        np.testing.assert_allclose(pps.numpy(), np.asarray(jps), rtol=0,
                                   atol=1e-6 * float(b.prob.max()) /
                                   (2 * np.pi / b.Ws * (1 - np.cos(np.pi / b.Hs))))


def open_scene(b, sphere: bool):
    """An open scene in the Cornell camera's frame (eye (500, 500, -1299)
    looking +z): a matte and a mirror floor at y = 0, an upright matte
    wall, and with `sphere` an analytic matte sphere, under the open sky,
    so that many escape rays leave and many are blocked. b: either
    package's SceneBuilder."""
    matte = b.add_material((0.6, 0.5, 0.4), (1.0, 1.0, 1.0), (0, 0, 0),
                           (1, 1, 1), (0, 0, 0), 50.0, 0)
    mirror = b.add_material((0, 0, 0), (0, 0, 0), (0, 0, 0),
                            (0.2, 0.2, 0.2), (3.0, 3.0, 3.0), 0.0, 1)
    for mat, x0, x1 in ((matte, -4000.0, 500.0), (mirror, 500.0, 5000.0)):
        z0, z1 = -2000.0, 8000.0
        b.add_triangle((x0, 0, z0), (x1, 0, z0), (x1, 0, z1), mat)
        b.add_triangle((x0, 0, z0), (x1, 0, z1), (x0, 0, z1), mat)
    b.add_triangle((-200, 0, 900), (400, 0, 900), (400, 700, 900), matte)
    b.add_triangle((-200, 0, 900), (400, 700, 900), (-200, 700, 900), matte)
    if sphere:
        b.add_analytic_sphere((750.0, 250.0, 600.0), 250.0, matte)
    b.end_obj()
    return b.build()


def _vertices(ps, n, seed):
    """Shading points (first hits of n camera rays that hit), flipped
    normals, materials, uniforms and throughputs."""
    rs = np.random.default_rng(seed)
    cam = library.cornell_camera(24, 16)
    ids = torch.from_numpy(rs.integers(0, 24 * 8, n).astype(np.int32))
    r = [torch.from_numpy(rs.random(n).astype(np.float32)) for _ in range(2)]
    rays = raygen.camera_rays(cam, ids, r[0], r[1])
    hit = make_intersect_fn(ps, "bruteforce")(rays)
    n_vec = vwhere(vdot(rays.d, hit.n) > 0.0, vneg(hit.n), hit.n)
    u = [torch.from_numpy(rs.random(n).astype(np.float32)) for _ in range(3)]
    f = [tuple(torch.from_numpy(rs.uniform(0.2, 1.0, n).astype(np.float32))
               for _ in range(3)) for _ in range(4)]
    return cam, rays, hit, n_vec, u, f


@pytest.mark.parametrize("sphere", [False, True])
@pytest.mark.parametrize("route", ["anyhit", "intersect"])
def test_direct_light_env_matches_jax(sphere, route):
    """The gather with its escape rays through the any-hit test (the
    port's K7 or-ed with the spheres against JAX's interpret-mode
    make_scene_occluded) and through the intersector, on the same
    vertices and draws of the sun-sky map."""
    js = open_scene(jbuilder.SceneBuilder(), sphere)
    ps = open_scene(builder.SceneBuilder(), sphere)
    a, b = _maps("sunsky")
    cam, rays, hit, n_vec, u, f = _vertices(ps, 400, 5)
    mat = ps.mats.take(hit.mati)
    jmat = js.mats.take_select(_j(hit.mati))
    is_diff = hit.valid & (mat.type == 0)
    anyhit = route == "anyhit"
    got = envmap.direct_light_env(
        b, intersect_fn=make_intersect_fn(ps, "auto"), cam_eye=cam.eye,
        hit_p=hit.p, n_vec=n_vec, mat=mat, f_l=f[0], f_b=f[1], f_s=f[2],
        f_r=f[3], is_diff=is_diff, u1=u[0], u2=u[1], u3=u[2],
        occluded_fn=make_scene_occluded(ps) if anyhit else None)
    # Interpret-mode K1 + K2 and K3b: the kernels' rounding, which XLA's
    # first_intersect does not share (a shadow ray leaving the floor
    # finds it again at t = 6e-4 there).
    tri = jminarg(js.tris, tr=256, interpret=True)
    jis = tri
    if sphere:
        sph = jsph(js.spheres, interpret=True)
        jis = lambda r: jisect.merge_hits(tri(r), sph(r))  # noqa: E731
    ref = je.direct_light_env(
        a, intersect_fn=jis, cam_eye=_j(cam.eye), hit_p=_j(hit.p),
        n_vec=_j(n_vec), mat=jmat, f_l=_j(f[0]), f_b=_j(f[1]), f_s=_j(f[2]),
        f_r=_j(f[3]), is_diff=_j(is_diff), u1=_j(u[0]), u2=_j(u[1]),
        u3=_j(u[2]),
        occluded_fn=jocc(js, interpret=True) if anyhit else None)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=RTOL, atol=ATOL)
    lit = _np(got).sum(0) > 0
    np.testing.assert_array_equal(lit, _np(ref).sum(0) > 0)
    # Many escape, many are blocked by the wall (and the sphere).
    assert 50 < lit.sum() < int(is_diff.sum()) - 50


@pytest.mark.parametrize("nee", [True, False])
def test_envmap_miss_update_matches_jax(nee):
    a, b = _maps("sunsky", nee=nee)
    rs = np.random.default_rng(6)
    n = 3000
    v = rs.normal(size=(3, n))
    d = tuple((v / np.linalg.norm(v, axis=0)).astype(np.float32))
    f = [tuple(rs.uniform(0.0, 1.0, n).astype(np.float32) for _ in range(3))
         for _ in range(5)]
    prev = np.where(rs.random(n) < 0.5, rs.random(n), 0.0).astype(np.float32)
    miss = rs.random(n) < 0.7
    prim = rs.random(n) < 0.3
    for is_primary in (prim, True, False):
        with jax.disable_jit():
            ref = je.envmap_miss_update(
                a, jnp.asarray(miss), jnp.asarray(is_primary),
                jnp.asarray(prev), *(_j(_t(x)) for x in f[:4]), _j(_t(d)),
                _j(_t(f[4])))
        got = envmap.envmap_miss_update(
            b, torch.from_numpy(miss),
            (torch.from_numpy(is_primary) if isinstance(is_primary,
                                                        np.ndarray)
             else is_primary),
            torch.from_numpy(prev), *(_t(x) for x in f[:4]), _t(d),
            _t(f[4]))
        np.testing.assert_allclose(_np(got), _np(ref), rtol=RTOL, atol=ATOL)


def _scenes():
    js = jlib.cornell_box(with_spheres=True)
    ps = library.cornell_box(with_spheres=True)
    return (js, functools.partial(jisect.first_intersect, tris=js.tris),
            ps, make_intersect_fn(ps, "bruteforce"))


@pytest.mark.parametrize("mode", ["parity", "fast"])
@pytest.mark.parametrize("sky,nee,iters", [("gradient", True, 3),
                                           ("sunsky", True, 5),
                                           ("sunsky", False, 3)])
def test_megakernel_envmap_render_matches_jax(mode, sky, nee, iters):
    js, jis, ps, pis = _scenes()
    a, b = _maps(sky, nee)
    kw = dict(num_pixels=W * H, iterations=iters, spp=2, mode=mode)
    with jax.disable_jit():
        j = jmk.render(jlib.cornell_camera(W, H), js.mats, intersect_fn=jis,
                       env=a, **kw)
    p = megakernel.render(library.cornell_camera(W, H), ps.mats,
                          intersect_fn=pis, env=b, device="cpu", **kw)
    np.testing.assert_allclose(megakernel.colors_array(p).numpy(),
                               np.asarray(jmk.colors_array(j)), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(p.rng_state.numpy(),
                                  np.asarray(j.rng_state).astype(np.int64))
    none = megakernel.render(library.cornell_camera(W, H), ps.mats,
                             intersect_fn=pis, device="cpu", **kw)
    assert float(megakernel.colors_array(p).sum()) > float(
        megakernel.colors_array(none).sum())


def _to_jax(st):
    f = interop.wavefront_state_to_numpy(st)
    return jwf.WavefrontState(**{
        k: (tuple(jnp.asarray(c) for c in v) if isinstance(v, tuple)
            else jnp.asarray(v, jnp.uint32) if k == "step"
            else jnp.asarray(v)) for k, v in f.items()})


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_wavefront_envmap_steps_match_jax(mode):
    """Six steps from one state, the gather (salt 5) and the MIS pickup
    per lane, with NEE on the sphere lamp's emitter table too."""
    js, jis, ps, pis = _scenes()
    a, b = _maps("sunsky")
    cam, jcam = library.cornell_camera(W, H), jlib.cornell_camera(W, H)
    st = wavefront.init_wavefront(cam, W * H, mode=mode, key=rng.key(2))
    for s in range(6):
        jst = _to_jax(st)
        st = wavefront.wavefront_step(cam, ps.mats, st, intersect_fn=pis,
                                      iterations=3, mode=mode,
                                      key=rng.key(2), env=b)
        with jax.disable_jit():
            jst = jwf.wavefront_step(jcam, js.mats, jst, intersect_fn=jis,
                                     iterations=3, mode=mode,
                                     key=jax.random.key(2), env=a)
        got = interop.wavefront_state_to_numpy(st)
        for name in ("colors", "cur_color", "prev_pdf"):
            np.testing.assert_allclose(_np(got[name]),
                                       _np(getattr(jst, name)), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{s}: {name}")
        for name in ("samples", "bounce"):
            np.testing.assert_array_equal(got[name],
                                          np.asarray(getattr(jst, name)))
    assert float(st.prev_pdf.max()) > 0.0


def test_interop_envmap_roundtrip():
    a = je.load_envmap("gradient", sample_res=(16, 8), nee=False)
    b = interop.envmap_from_numpy(np.asarray(a.img), np.asarray(a.prob),
                                  np.asarray(a.cum), Wi=a.Wi, Hi=a.Hi,
                                  Ws=a.Ws, Hs=a.Hs, nee=a.nee)
    c = envmap.load_envmap("gradient", sample_res=(16, 8), nee=False)
    d = interop.envmap_to_numpy(b)
    for f in ("img", "prob", "cum"):
        assert torch.equal(getattr(b, f), getattr(c, f))
        np.testing.assert_array_equal(d[f], np.asarray(getattr(a, f)))
    assert (d["Wi"], d["Hi"], d["Ws"], d["Hs"], d["nee"]) == (
        a.Wi, a.Hi, a.Ws, a.Hs, False)
