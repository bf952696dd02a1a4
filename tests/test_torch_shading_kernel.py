"""K8, the smooth refine (`ops/kernels/shading_kernel.py`), and the smooth
intersector routes of the port, against the JAX package on the CPU.

The reference is the Pallas kernel in interpret mode
(`make_smooth_minarg_intersect(interpret=True)`), on the camera rays of
the smooth-sphere Cornell box and of the reference scene, plus rays
aimed at random triangles of each. A probe of the interpret-mode kernel
found XLA's fused multiply-adds at p = o + d t, at the first two terms
of each dot product and blend, and at |n|^2, which the plain version
repeats, and an approximate `rsqrt`: every lane's unnormalised normal is
bit-equal, and on some smooth lanes the normalised one differs from a
correctly rounded 1 / sqrt by an ulp of 1/|n|. So t, the
material (miss lanes included) and the face-normal fallbacks are held
bit-equal, and the smooth normals, unit vectors, to atol 1e-6 (a few
ulps of 1; the JAX package's own test allows 2e-5)."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.core.types import Rays as JRays
from opencl_path_tracer_tpu.ops import raygen as jraygen
from opencl_path_tracer_tpu.ops import shading as jshading
from opencl_path_tracer_tpu.ops.pallas import shading_kernel as jsk
from opencl_path_tracer_tpu.ops.pallas.intersect_kernel import (
    _round_up, _run_minarg, build_tri_pack as jbuild_tri_pack,
    pack_rays as jpack_rays,
)
from opencl_path_tracer_tpu.ops.pallas.plucker_kernel import (
    make_minarg_intersect as jminarg,
)
from opencl_path_tracer_tpu.ops.pallas.tilecull_kernel import (
    make_tilecull_intersect as jtilecull,
)
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.core.types import Rays
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.ops.kernels import shading_kernel as k8
from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

MODELS = str(pathlib.Path(__file__).resolve().parent / "assets" / "models")
NORMAL_ATOL = 1e-6
SCENES = ("cornell-smooth", "reference")


def _scenes(name):
    if name == "cornell-smooth":
        kw = dict(with_spheres=True, smooth_spheres=True)
        return (jlib.cornell_box(**kw), library.cornell_box(**kw),
                (jlib.cornell_camera(48, 48), 48, 48))
    return (jlib.reference_scene(MODELS, smooth=True),
            library.reference_scene(MODELS, smooth=True),
            (jlib.reference_camera(48, 36), 48, 36))


def _rays(name, js, jcam, n_aimed=1500):
    """Camera rays with numpy jitter, rays from random origins aimed at
    random triangle centroids (most of them hit a smooth triangle), and
    a few aimed away from them (some miss): (p, d), two (N, 3) float32
    arrays."""
    rs = np.random.default_rng(11)
    jcam, w, h = jcam
    n_px = w * h
    ids = jraygen.pixel_ids(w, h)
    u = [jnp.asarray(rs.uniform(size=n_px).astype(np.float32))
         for _ in range(2)]
    cr = jraygen.camera_rays(jcam, ids, u[0], u[1])
    cp = np.stack([np.asarray(c) for c in cr.p], -1)
    cd = np.stack([np.asarray(c) for c in cr.d], -1)
    r1, r2, r3 = (np.asarray(getattr(js.tris, f)) for f in ("r1", "r2", "r3"))
    cen = (r1 + r2 + r3) / 3.0
    lo, hi = ((-100.0, 1.0, -1000.0), (1100.0, 999.0, 1000.0)) \
        if name == "cornell-smooth" else ((-900.0, 5.0, -700.0),
                                          (400.0, 1300.0, 400.0))
    ap = rs.uniform(lo, hi, size=(n_aimed, 3))
    ad = cen[rs.integers(0, len(cen), n_aimed)] - ap
    ad /= np.linalg.norm(ad, axis=1, keepdims=True)
    return (np.concatenate([cp, ap, ap[:300]]).astype(np.float32),
            np.concatenate([cd, ad, -ad[:300]]).astype(np.float32))


def _both(p, d):
    jr = JRays(p=tuple(jnp.asarray(p[:, k]) for k in range(3)),
               d=tuple(jnp.asarray(d[:, k]) for k in range(3)))
    pr = Rays(p=tuple(torch.from_numpy(np.ascontiguousarray(p[:, k]))
                      for k in range(3)),
              d=tuple(torch.from_numpy(np.ascontiguousarray(d[:, k]))
                      for k in range(3)))
    return jr, pr


def _assert_normals(n, ref, smooth, what):
    """Bit-equal off the smooth lanes; within NORMAL_ATOL on them."""
    for k in range(3):
        a, b = n[k], ref[k]
        assert np.array_equal(a[~smooth].view(np.uint32),
                              b[~smooth].view(np.uint32)), f"{what} n{k}"
        np.testing.assert_allclose(a[smooth], b[smooth], rtol=0,
                                   atol=NORMAL_ATOL, err_msg=f"{what} n{k}")
    bit = np.mean([np.array_equal(n[k][i], ref[k][i])
                   for i in np.flatnonzero(smooth) for k in range(3)])
    assert bit > 0.85, f"{what}: only {bit:.3f} of smooth values bit-equal"


@pytest.mark.parametrize("name", SCENES)
def test_kernel_outputs_match_interpret_mode(name):
    """K8's five rows, before the hit assembly (so a miss lane's material
    is triangle 0's): the port's on K1's (t, g) against interpret-mode
    K8 on interpret-mode K1's."""
    js, ps, jcam = _scenes(name)
    p, d = _rays(name, js, jcam)
    jr, pr = _both(p, d)
    r = p.shape[0]
    rays8 = jpack_rays(jr.p, jr.d, _round_up(r, 1024))
    jpack = jbuild_tri_pack(js.tris, 1024)
    t1, g1 = (o.reshape(1, -1) for o in _run_minarg(
        rays8, jpack, 1024, min(1024, jpack.shape[0]), True, 512))
    tabt = jsk._split3_table(np.ascontiguousarray(
        np.asarray(jpack)[:, :17].T))
    stab = jsk.build_shading_pack(js.attribs, jpack.shape[0])
    ref = [np.asarray(o)[0, :r] for o in jsk._run_smooth_refine(
        rays8, t1, g1, tabt, stab, 1024, True)]

    pack = k1.build_tri_pack(ps.tris)
    r8 = k1.pack_rays(pr.p, pr.d)
    pt1, pg1 = k1.minarg(r8, pack)
    assert np.array_equal(pg1.numpy(), np.asarray(g1)[0, :r])
    out = [o.numpy() for o in k8.smooth_refine(
        r8, pt1, pg1, pack, k8.build_shading_pack(ps.attribs))]
    assert np.array_equal(out[0], ref[0])
    assert np.array_equal(out[4], ref[4])
    miss = out[0] < 0
    assert miss.any() and (~miss).any()
    smooth = (~miss) & (out[1] != pack[pg1.long(), 0].numpy())
    assert smooth.sum() > 300
    _assert_normals(out[1:4], ref[1:4], smooth, name)


@pytest.mark.parametrize("name", SCENES)
def test_smooth_minarg_intersect_matches_jax(name):
    """The whole minarg route (K1, then K8, then the hit assembly) against
    JAX's make_smooth_minarg_intersect in interpret mode, and the engine
    picks it for accel='auto' with smooth=True."""
    js, ps, jcam = _scenes(name)
    p, d = _rays(name, js, jcam, n_aimed=600)
    jr, pr = _both(p, d)
    ref = jsk.make_smooth_minarg_intersect(js.tris, js.attribs,
                                           interpret=True)(jr)
    got = make_intersect_fn(ps, "auto", smooth=True)(pr)
    assert np.array_equal(got.t.numpy(), np.asarray(ref.t))
    assert np.array_equal(got.mati.numpy(), np.asarray(ref.mati))
    for k in range(3):
        assert np.array_equal(got.p[k].numpy(), np.asarray(ref.p[k]))
    face = make_intersect_fn(ps, "auto")(pr)
    smooth = got.t.numpy() > 0
    smooth &= np.any([got.n[k].numpy() != face.n[k].numpy()
                      for k in range(3)], axis=0)
    _assert_normals([c.numpy() for c in got.n],
                    [np.asarray(c) for c in ref.n], smooth, name)


@pytest.mark.parametrize("accel", ["tilecull", "bruteforce"])
def test_smooth_id_routes_match_jax(accel):
    """'tilecull' (K6 with ids) and 'bruteforce' (plain K1 + K2 with ids)
    each followed by smooth_hit_normals, against JAX's interpret-mode
    tilecull and minarg intersectors with ids and its op-by-op
    smooth_hit_normals on the reference scene."""
    js, ps, jcam = _scenes("reference")
    p, d = _rays("reference", js, jcam, n_aimed=600)
    jr, pr = _both(p, d)
    ids_fn = (jtilecull(js.tris, with_ids=True, interpret=True)
              if accel == "tilecull"
              else jminarg(js.tris, with_ids=True, tr=256, interpret=True))
    jh, jids = ids_fn(jr)
    ref = jshading.smooth_hit_normals(jh, jids, js.attribs)
    got = make_intersect_fn(ps, accel, smooth=True)(pr)
    assert np.array_equal(got.t.numpy(), np.asarray(ref.t))
    assert np.array_equal(got.mati.numpy(), np.asarray(ref.mati))
    hit = np.asarray(jids) >= 0
    smooth = hit & np.any(
        [np.asarray(ref.n[k]) != np.asarray(jh.n[k]) for k in range(3)],
        axis=0)
    assert smooth.sum() > 300 and (~hit).any()
    if accel == "bruteforce":
        # The plain reference zeroes a miss lane's normal, as JAX's XLA
        # first_intersect_ids does; the kernels leave triangle 0's.
        assert all((c.numpy()[~hit] == 0).all() for c in got.n)
        got_n = [c.numpy()[hit] for c in got.n]
        ref_n = [np.asarray(c)[hit] for c in ref.n]
        smooth = smooth[hit]
    else:
        got_n = [c.numpy() for c in got.n]
        ref_n = [np.asarray(c) for c in ref.n]
    _assert_normals(got_n, ref_n, smooth, accel)


def test_wrapper_checks_and_cpu_route():
    """CPU tensors take the plain version; bad shapes and devices raise."""
    ps = library.cornell_box(with_spheres=True, smooth_spheres=True)
    pack = k1.build_tri_pack(ps.tris)
    spack = k8.build_shading_pack(ps.attribs)
    assert spack.shape == (ps.num_triangles, 17) and spack.is_contiguous()
    rs = np.random.default_rng(2)
    r8 = torch.zeros((8, 257))
    r8[0:3] = torch.from_numpy(rs.uniform(0, 900, (3, 257)).astype(
        np.float32))
    r8[3:6] = torch.from_numpy(rs.normal(size=(3, 257)).astype(np.float32))
    t, g = k1.minarg(r8, pack)
    got = k8.smooth_refine(r8, t, g, pack, spack)
    for a, b in zip(got, k8.smooth_refine_plain(r8, t, g, pack, spack)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shading_pack"):
        k8.smooth_refine(r8, t, g, pack, spack[:-1])
    with pytest.raises(ValueError, match="g1"):
        k8.smooth_refine(r8, t, g[:-1], pack, spack)
    with pytest.raises(TypeError):
        k8.smooth_refine(r8, t, g.double(), pack, spack)
    with pytest.raises(ValueError, match="attribs cover"):
        k8.make_smooth_minarg_intersect(
            library.cornell_box(with_spheres=False).tris, ps.attribs)
