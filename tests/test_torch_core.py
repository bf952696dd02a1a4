"""The port's core types, scene build and camera against the JAX package.

Scene constants and the Cornell camera must be bit-equal; the
reference-pose camera is held to one float32 ulp because XLA's
cos/sin are not correctly rounded while the port's host trigonometry is.
"""

import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.core import camera as jcam
from opencl_path_tracer_tpu.core.geometry import TrianglesSoA as JTris
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import interop
from opencl_path_tracer_tpu_torch.core import camera as pcam
from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.materials import reference_archetypes
from opencl_path_tracer_tpu_torch.scene import library as plib

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

TRI_FIELDS = ("r1", "r2", "r3", "n", "mati", "m1", "m2", "m3", "c0", "d1",
              "d2", "d3")
SCENES = [dict(with_spheres=False), dict(with_spheres=True),
          dict(with_spheres=True, analytic_spheres=True)]


def _bits(a):
    """Compare float arrays by bit pattern (so -0.0 != +0.0)."""
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_tris_equal(jt, pt):
    for f in TRI_FIELDS:
        np.testing.assert_array_equal(
            _bits(getattr(pt, f).numpy()), _bits(getattr(jt, f)), err_msg=f)


@pytest.mark.parametrize("kw", SCENES, ids=["empty", "spheres", "analytic"])
def test_cornell_scene_constants_bit_equal(kw):
    js, ps = jlib.cornell_box(**kw), plib.cornell_box(**kw)
    _assert_tris_equal(js.tris, ps.tris)
    np.testing.assert_array_equal(ps.object_ranges, js.object_ranges)
    for f in ("kd", "ks", "emission", "f0"):
        for k in range(3):
            np.testing.assert_array_equal(
                _bits(getattr(ps.mats, f)[k].numpy()),
                _bits(getattr(js.mats, f)[k]))
    for f in ("n", "shininess", "type"):
        np.testing.assert_array_equal(getattr(ps.mats, f).numpy(),
                                      np.asarray(getattr(js.mats, f)))
    assert (ps.spheres is None) == (js.spheres is None)
    if js.spheres is not None:
        for k in range(3):
            np.testing.assert_array_equal(ps.spheres.c[k].numpy(),
                                          np.asarray(js.spheres.c[k]))
        np.testing.assert_array_equal(ps.spheres.rad.numpy(),
                                      np.asarray(js.spheres.rad))
        np.testing.assert_array_equal(ps.spheres.mati.numpy(),
                                      np.asarray(js.spheres.mati))


def test_random_triangle_constants_bit_equal_with_degenerates():
    rs = np.random.default_rng(5)
    v = rs.normal(size=(3, 400, 3)).astype(np.float32) * 50.0
    v[1, :20] = v[0, :20]            # zero-area triangles: n = 0, not NaN
    mati = rs.integers(0, 10, 400).astype(np.int32)
    jt = JTris.build(v[0], v[1], v[2], mati)
    pt = TrianglesSoA.build(v[0], v[1], v[2], mati)
    _assert_tris_equal(jt, pt)
    assert np.all(pt.n[:20].numpy() == 0.0)


def test_material_archetypes():
    rows = reference_archetypes()
    assert len(rows) == 10
    assert [int(r["type"]) for r in rows] == [3, 3, 0, 0, 0, 0, 0, 1, 1, 2]


@pytest.mark.parametrize("w,h", [(16, 16), (64, 48), (1920, 1080)])
def test_cornell_camera_bit_equal(w, h):
    jc, pc = jlib.cornell_camera(w, h), plib.cornell_camera(w, h)
    for f in ("eye", "lookat", "up", "right"):
        np.testing.assert_array_equal(_bits(getattr(pc, f).numpy()),
                                      _bits(getattr(jc, f)), err_msg=f)
    assert pc.xm == float(jc.xm) and pc.ym == float(jc.ym)


def test_reference_pose_camera_within_one_ulp():
    kw = dict(fov=75.0, yaw=-63.800002, pitch=15.599997,
              shift=(265.055481, 162.305969, 360.414001))
    jc = jcam.make_camera(320, 200, **kw)
    pc = pcam.make_camera(320, 200, **kw)
    for f in ("eye", "lookat", "up", "right"):
        np.testing.assert_allclose(getattr(pc, f).numpy(),
                                   np.asarray(getattr(jc, f)),
                                   rtol=2.4e-7, atol=1e-4, err_msg=f)


def test_fma_is_single_rounding():
    rs = np.random.default_rng(0)
    a, b, c = (rs.standard_normal(20000).astype(np.float32)
               for _ in range(3))
    got = fp.fma(torch.from_numpy(a), torch.from_numpy(b),
                 torch.from_numpy(c)).numpy()
    # The exact rational value, rounded to the nearest float32.
    from fractions import Fraction
    for i in range(0, 20000, 199):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(
            float(c[i]))
        assert got[i] == np.float32(float(exact))
    plain = a * b + c
    assert (got != plain).any()       # it is not the two-rounding form


def test_sqrt_correctly_rounded():
    x = np.random.default_rng(1).random(100000).astype(np.float32) * 1e5
    np.testing.assert_array_equal(fp.sqrt(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))


def test_scene_from_numpy_matches_builder():
    js = jlib.cornell_box(with_spheres=True, analytic_spheres=True)
    t, m = js.tris, js.mats
    ps = interop.scene_from_numpy(
        np.asarray(t.r1), np.asarray(t.r2), np.asarray(t.r3),
        np.asarray(t.mati),
        {f: getattr(m, f) for f in ("kd", "ks", "emission", "f0", "n",
                                    "shininess", "type")},
        object_ranges=js.object_ranges,
        spheres={"c": js.spheres.c, "rad": js.spheres.rad,
                 "mati": js.spheres.mati})
    _assert_tris_equal(t, ps.tris)
    ref = plib.cornell_box(with_spheres=True, analytic_spheres=True)
    for k in range(3):
        assert torch.equal(ps.mats.kd[k], ref.mats.kd[k])
        assert torch.equal(ps.spheres.c[k], ref.spheres.c[k])
