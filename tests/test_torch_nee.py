"""Next-event estimation in the port (`ops/nee.py`) against the JAX
package's `ops/nee.py` on the CPU.

The emitter tables are equal field by field (cornell, the sphere lamp, a
mixed triangle and sphere scene, many_light_scene(8)), with both
ValueErrors. The samplers, the gather and the pickup weight run on the
same uniforms and shading points in both packages, JAX op by op (eager).
Every operation is the same IEEE operation except cos, sin and pow,
whose float32 results may differ by an ulp in the two libraries, so 98 %
of the values agree to rtol 2e-6 and all to the goldens' rtol 1e-4
with atol 5e-5: a cone sample near a sphere's silhouette, where the
forward hit is ill-conditioned, turns the ulp of cos into 6e-4 in y
(rel 1.5e-6), and the normal (y - c) / r of a 10-unit lamp into 1.6e-5.
Visibility decisions are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.ops import intersect as jisect
from opencl_path_tracer_tpu.ops import nee as jnee
from opencl_path_tracer_tpu.ops.pallas.plucker_kernel import (
    make_minarg_intersect as jminarg,
)
from opencl_path_tracer_tpu.ops.pallas.sphere_kernel import (
    make_sphere_table_intersect as jsph,
)
from opencl_path_tracer_tpu.scene import builder as jbuilder
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.core.types import Rays, vneg, vwhere, vdot
from opencl_path_tracer_tpu_torch.ops import nee, raygen
from opencl_path_tracer_tpu_torch.ops.kernels.tilecull_kernel import (
    make_scene_occluded,
)
from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
from opencl_path_tracer_tpu_torch.scene import builder, library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 5e-5      # every value
TIGHT = 2e-6                  # 98 % of the values


def _mixed(b):
    """tests/test_nee.py's scene: a floor, a triangle lamp, a sphere lamp."""
    b.add_material((0.7, 0.7, 0.7), (0, 0, 0), (0, 0, 0), (1, 1, 1),
                   (0, 0, 0), 50.0, 0)
    b.add_material((0, 0, 0), (0, 0, 0), (8.0, 8.0, 8.0), (1, 1, 1),
                   (0, 0, 0), 50.0, 3)
    b.add_material((0, 0, 0), (0, 0, 0), (4.0, 4.0, 4.0), (1, 1, 1),
                   (0, 0, 0), 50.0, 3)
    b.add_triangle((-600, 0, -600), (600, 0, -600), (-600, 0, 600), 0)
    b.add_triangle((600, 0, -600), (600, 0, 600), (-600, 0, 600), 0)
    b.add_triangle((-200, 500, -100), (0, 500, -100), (-200, 500, 100), 1)
    b.add_triangle((0, 500, -100), (0, 500, 100), (-200, 500, 100), 1)
    b.add_analytic_sphere((250.0, 350.0, 0.0), 60.0, 2)
    return b.build()


SCENES = {
    "cornell": (lambda: jlib.cornell_box(with_spheres=True),
                lambda: library.cornell_box(with_spheres=True), "power"),
    "sphere-lamp": (
        lambda: jlib.cornell_box(with_spheres=True, analytic_spheres=True,
                                 sphere_lamp=True),
        lambda: library.cornell_box(with_spheres=True, analytic_spheres=True,
                                    sphere_lamp=True), "power"),
    "mixed": (lambda: _mixed(jbuilder.SceneBuilder()),
              lambda: _mixed(builder.SceneBuilder()), "power"),
    "many-lights-8": (lambda: jlib.many_light_scene(8),
                      lambda: library.many_light_scene(8), "distance"),
}


def _tables(name):
    jmake, pmake, select = SCENES[name]
    js, ps = jmake(), pmake()
    return (js, jnee.build_emitter_table(js.tris, js.mats, js.spheres,
                                         select=select),
            ps, nee.build_emitter_table(ps.tris, ps.mats, ps.spheres,
                                        select=select))


def _np(x):
    if isinstance(x, tuple):
        return np.stack([_np(c) for c in x])
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", list(SCENES))
def test_emitter_table_equals_jax(name):
    _, jt, _, pt = _tables(name)
    for f in ("v0", "e1", "e2", "m", "emission", "cum", "p_area",
              "total_area", "power_lum", "packed", "s_c", "s_rad",
              "s_emission", "s_sel", "s_mati", "s_packed"):
        np.testing.assert_array_equal(_np(getattr(pt, f)),
                                      _np(getattr(jt, f)), err_msg=f)
    assert (pt.count, pt.tri_count, pt.sphere_count, pt.select) == (
        jt.count, jt.tri_count, jt.sphere_count, jt.select)


def test_emitter_table_errors():
    b = builder.SceneBuilder()
    b.add_material((0, 0, 0), (0, 0, 0), (5.0, 5.0, 5.0), (1, 1, 1),
                   (0, 0, 0), 50.0, 3)
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), 0)
    b.add_analytic_sphere((0.0, 5.0, 0.0), 1.0, 0)
    s = b.build()
    with pytest.raises(ValueError, match="kind"):
        nee.build_emitter_table(s.tris, s.mats, s.spheres)
    c = library.cornell_box(with_spheres=True)
    with pytest.raises(ValueError, match="distance"):
        nee.build_emitter_table(c.tris, c.mats, None, select="distance")
    with pytest.raises(ValueError, match="select"):
        nee.build_emitter_table(c.tris, c.mats, None, select="nearest")
    dark = library.cornell_box(with_spheres=False)
    for c in dark.mats.emission:
        c.zero_()
    with pytest.raises(ValueError, match="at least one emitter"):
        nee.build_emitter_table(dark.tris, dark.mats, None)


def _vertices(ps, n, seed, w=24, h=16):
    """Shading points: the first hits of n of the scene's camera rays (in
    the port), with flipped normals, their materials and random uniforms
    and throughputs, as port tensors and JAX arrays."""
    rs = np.random.default_rng(seed)
    cam = library.cornell_camera(w, h)
    ids = torch.from_numpy(rs.integers(0, w * h, n).astype(np.int32))
    r = [torch.from_numpy(rs.random(n).astype(np.float32)) for _ in range(2)]
    rays = raygen.camera_rays(cam, ids, r[0], r[1])
    hit = make_intersect_fn(ps, "bruteforce")(rays)
    n_vec = vwhere(vdot(rays.d, hit.n) > 0.0, vneg(hit.n), hit.n)
    u = [torch.from_numpy(rs.random(n).astype(np.float32)) for _ in range(3)]
    f = [tuple(torch.from_numpy(rs.uniform(0.2, 1.0, n).astype(np.float32))
               for _ in range(3)) for _ in range(4)]
    return cam, rays, hit, n_vec, u, f


def _j(x):
    if isinstance(x, tuple):
        return tuple(_j(c) for c in x)
    return jnp.asarray(x.numpy())


def _close(p, j, what):
    a, b = _np(p), _np(j)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=what)
    tight = np.abs(a - b) <= TIGHT * np.abs(b) + 1e-9
    assert tight.mean() >= 0.98, (what, tight.mean())


@pytest.mark.parametrize("name", list(SCENES))
def test_sample_emitters_matches_jax(name):
    """Power (triangles), cone (sphere lamp), mixed and distance select."""
    _, jt, ps, pt = _tables(name)
    _, _, hit, n_vec, u, _ = _vertices(ps, 500, 1)
    origin = tuple(hit.p[k] + n_vec[k] * 1e-3 for k in range(3))
    got = nee.sample_emitters(pt, u[0], u[1], u[2], origin=origin)
    ref = jnee.sample_emitters(jt, _j(u[0]), _j(u[1]), _j(u[2]),
                               origin=_j(origin))
    for what, a, b in zip(("y", "m", "emission", "p_area"), got, ref):
        _close(a, b, what)


def _jax_isect(js):
    """Interpret-mode K1 + K2, merged with interpret-mode K3b: on rays that
    start at a sphere's surface, interpret-mode K3 rounds t through
    separate XLA fusions that no elementwise form reproduces (ROADMAP.md
    queue 3), and the port's K3 and K3b both round as K3b does."""
    tri = jminarg(js.tris, tr=256, interpret=True)
    if js.spheres is None:
        return tri
    sph = jsph(js.spheres, interpret=True)
    return lambda rays: jisect.merge_hits(tri(rays), sph(rays))


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("anyhit", [False, True])
def test_direct_light_matches_jax(name, anyhit):
    """The gather through the nearest-hit route and the any-hit route
    (port: K7 | spheres; JAX: the intersector), on the same vertices."""
    js, jt, ps, pt = _tables(name)
    cam, rays, hit, n_vec, u, f = _vertices(ps, 500, 2)
    mat = ps.mats.take(hit.mati)
    jmat = js.mats.take_select(_j(hit.mati))
    is_diff = hit.valid & (mat.type == 0)
    got = nee.direct_light(
        pt, intersect_fn=make_intersect_fn(ps, "bruteforce"),
        cam_eye=cam.eye, hit_p=hit.p, n_vec=n_vec, mat=mat, f_l=f[0],
        f_b=f[1], f_s=f[2], f_r=f[3], is_diff=is_diff, u1=u[0], u2=u[1],
        u3=u[2], occluded_fn=make_scene_occluded(ps) if anyhit else None)
    ref = jnee.direct_light(
        jt, intersect_fn=_jax_isect(js), cam_eye=_j(cam.eye),
        hit_p=_j(hit.p), n_vec=_j(n_vec), mat=jmat, f_l=_j(f[0]),
        f_b=_j(f[1]), f_s=_j(f[2]), f_r=_j(f[3]), is_diff=_j(is_diff),
        u1=_j(u[0]), u2=_j(u[1]), u3=_j(u[2]))
    _close(got, ref, "contribution")
    lit = _np(got).sum(0) > 0
    np.testing.assert_array_equal(lit, _np(ref).sum(0) > 0)
    assert 20 < lit.sum() <= int(is_diff.sum())


@pytest.mark.parametrize("name", list(SCENES))
def test_pickup_mis_weight_matches_jax(name):
    """The pickup weight at emitter hits of cosine-sampled rays from
    diffuse vertices (and full weight where prev_pdf is 0)."""
    js, jt, ps, pt = _tables(name)
    _, _, hit, n_vec, u, _ = _vertices(ps, 2000, 3)
    from opencl_path_tracer_tpu_torch.ops import bsdf
    p, d = bsdf.diffuse_ray(hit.p, n_vec, u[0], u[1])
    h2 = make_intersect_fn(ps, "bruteforce")(Rays(p=p, d=d))
    m2 = ps.mats.take(h2.mati)
    nf = vwhere(vdot(d, h2.n) > 0.0, vneg(h2.n), h2.n)
    emit_cos = torch.clamp_min(-vdot(d, nf), 0.0)
    prev = torch.where(u[2] < 0.2, torch.zeros_like(u[2]),
                       torch.clamp_min(vdot(d, n_vec), 0.0) * 0.3183099)
    got = nee.pickup_mis_weight(pt, prev, emit_cos, h2.t, m2.emission,
                                mati=h2.mati, hit_p=h2.p, ray_p=p)
    ref = jnee.pickup_mis_weight(jt, _j(prev), _j(emit_cos), _j(h2.t),
                                 _j(m2.emission), mati=_j(h2.mati),
                                 hit_p=_j(h2.p), ray_p=_j(p))
    _close(got, ref, "weight")
    emit = (h2.valid & (m2.type == 3) & (prev > 0)).numpy()
    assert emit.sum() > 0
    w = got.numpy()[emit]
    assert ((w > 0) & (w < 1)).all()


def _where_chain_rows(packed, idx, ncols):
    """The row fetch the port had before: a chain of wheres over the rows
    (the JAX package's choice for tables of 64 rows or fewer)."""
    cols = []
    for c in range(ncols):
        out = packed[0, c].expand(idx.shape)
        for j in range(1, packed.shape[0]):
            out = torch.where(idx == j, packed[j, c], out)
        cols.append(out)
    return cols


@pytest.mark.parametrize("rows", [1, 2, 64, 65])
def test_fetch_rows_gather_equals_where_chain(rows):
    """NEE's one row gather returns the where-chain's bits on every index
    NEE produces ([0, rows - 1]), signed zeros and infinities included."""
    rs = np.random.default_rng(rows)
    packed = rs.normal(size=(rows, 16)).astype(np.float32)
    packed[:, 3] = -0.0
    packed[rows // 2, 5] = 0.0
    packed[-1, 7] = -np.inf
    packed = torch.from_numpy(packed)
    idx = torch.from_numpy(rs.integers(0, rows, 777).astype(np.int32))
    idx[:rows] = torch.arange(rows, dtype=torch.int32)
    got = nee._fetch_rows(packed, idx, 16)
    for a, b in zip(got, _where_chain_rows(packed, idx, 16)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
