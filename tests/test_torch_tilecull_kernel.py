"""K6 (tile-culled nearest hit) and K7 (any-hit shadow rays) in the port
against the JAX package's tilecull kernels run in interpret mode, as
tests/test_tilecull.py runs them: `build_groups` gives the same order,
boxes and spans; K6's t, normal, mati and original-order ids are
bit-equal (with and without the front-to-back `origin` order); K7's
flags are bit-equal, and equal (K4's t valid and t < rmax), for a finite
rmax and for rmax = BIG; `make_scene_occluded` ORs in the spheres."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.core.geometry import TrianglesSoA as JTris
from opencl_path_tracer_tpu.core.types import Rays as JRays
from opencl_path_tracer_tpu.ops.pallas import tilecull_kernel as jtk
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.types import Rays
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.ops.kernels import tilecull_kernel as tk
from opencl_path_tracer_tpu_torch.scene import library as plib

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

BIG = 3.0e38


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _scene(t, seed=0, spread=10.0):
    """tests/test_tilecull.py's random triangle soup, in both packages."""
    rs = np.random.default_rng(seed)
    centers = rs.uniform(-spread, spread, size=(t, 1, 3))
    v = (centers + rs.normal(size=(t, 3, 3)) * 0.6).astype(np.float32)
    mati = np.arange(t, dtype=np.int32) % 7
    return (JTris.build(v[:, 0], v[:, 1], v[:, 2], mati),
            TrianglesSoA.build(v[:, 0], v[:, 1], v[:, 2], mati))


def _rays(n, seed=1, spread=12.0, tris=None):
    """Random rays, a tenth of them exactly axis-aligned (the slab's
    clamped-reciprocal path); given tris, half of the others aim near a
    triangle's centroid."""
    rs = np.random.default_rng(seed)
    p = rs.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    k = n // 10
    if tris is not None:
        cen = (tris.r1 + tris.r2 + tris.r3).numpy() / 3.0
        a = np.arange(k, k + (n - k) // 2)
        d[a] = (cen[rs.integers(0, cen.shape[0], a.size)]
                + rs.normal(size=(a.size, 3)) * 0.2 - p[a])
    d[:k] = 0.0
    d[np.arange(k), rs.integers(0, 3, size=k)] = rs.choice([-1.0, 1.0], k)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return _both(p, d)


def _both(p, d):
    return (JRays(p=tuple(jnp.asarray(p[:, k]) for k in range(3)),
                  d=tuple(jnp.asarray(d[:, k]) for k in range(3))),
            Rays(p=tuple(torch.from_numpy(p[:, k].copy()) for k in range(3)),
                 d=tuple(torch.from_numpy(d[:, k].copy())
                         for k in range(3))))


@pytest.mark.parametrize("origin", [None, (0.0, 0.0, -30.0)])
def test_build_groups_equals_jax(origin):
    jt, pt = _scene(200)
    _, jperm, jboxes, jspans = jtk.build_groups(jt, 32, origin=origin)
    p2, perm, boxes, spans = tk.build_groups(pt, 32, origin=origin)
    np.testing.assert_array_equal(perm, jperm)
    assert boxes == jboxes and spans == jspans
    np.testing.assert_array_equal(p2.n.numpy(), pt.n.numpy()[perm])
    table = tk.group_table(boxes, spans, "cpu").numpy()
    np.testing.assert_array_equal(table[:, :6], np.float32(
        [list(lo) + list(hi) for lo, hi in jboxes]))


def _assert_hits_equal(ph, jh):
    np.testing.assert_array_equal(_bits(ph.t.numpy()), _bits(jh.t))
    np.testing.assert_array_equal(ph.mati.numpy(), np.asarray(jh.mati))
    for k in range(3):
        np.testing.assert_array_equal(_bits(ph.n[k].numpy()), _bits(jh.n[k]))
        np.testing.assert_array_equal(_bits(ph.p[k].numpy()), _bits(jh.p[k]))


@pytest.mark.parametrize("origin", [None, (0.0, 0.0, -30.0)])
def test_tilecull_matches_interpret_mode(origin):
    jt, pt = _scene(200, seed=3)
    jr, pr = _rays(400, seed=4, tris=pt)
    jh, jids = jtk.make_tilecull_intersect(jt, gs=32, with_ids=True,
                                           origin=origin, interpret=True)(jr)
    ph, ids = tk.make_tilecull_intersect(pt, gs=32, with_ids=True,
                                         origin=origin)(pr)
    _assert_hits_equal(ph, jh)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert (ids.numpy() >= 0).sum() > 100


def test_tilecull_t_equals_minarg_on_cornell():
    """On the Cornell box's camera rays and on rays from inside the box,
    K6's t equals K1's on every ray and the Hits equal interpret-mode
    K6's."""
    js = jlib.cornell_box(with_spheres=True)
    ps = plib.cornell_box(with_spheres=True)
    rs = np.random.default_rng(7)
    eye = plib.cornell_camera(8, 8).eye.numpy()
    p = np.concatenate([np.broadcast_to(eye, (200, 3)),
                        rs.uniform([0, 10, -200], [1000, 990, 900],
                                   (200, 3))]).astype(np.float32)
    d = rs.normal(size=(400, 3)).astype(np.float32)
    d[:200, 2] = np.abs(d[:200, 2]) + 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jr, pr = _both(p, d)
    ph = tk.make_tilecull_intersect(ps.tris, origin=tuple(eye))(pr)
    jh = jtk.make_tilecull_intersect(js.tris, origin=tuple(eye),
                                     interpret=True)(jr)
    _assert_hits_equal(ph, jh)
    t1, _ = k1.minarg(k1.pack_rays(pr.p, pr.d), k1.build_tri_pack(ps.tris))
    t1 = torch.where(t1 < BIG, t1, torch.full_like(t1, -1.0))
    assert torch.equal(ph.t, t1)


@pytest.mark.parametrize("seed,finite", [(0, True), (5, True), (7, False)])
def test_anyhit_matches_interpret_mode_and_nearest_hit(seed, finite):
    jt, pt = _scene(200, seed=seed)
    jr, pr = _rays(400, seed=seed + 1, tris=pt)
    rs = np.random.default_rng(seed + 2)
    rmax = (rs.uniform(0.5, 25.0, size=400).astype(np.float32) if finite
            else np.full(400, BIG, np.float32))
    jocc = jtk.make_anyhit_occluded(jt, gs=32, interpret=True)(
        jr, jnp.asarray(rmax))
    occ = tk.make_anyhit_occluded(pt, gs=32)(pr, torch.from_numpy(rmax))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    t, _ = k1.minarg(k1.pack_rays(pr.p, pr.d), k1.build_tri_pack(pt))
    expect = (t < BIG) & (t < torch.from_numpy(rmax))
    assert torch.equal(occ, expect)
    assert 40 < int(occ.sum()) < 400


def test_scene_occluded_with_spheres():
    """make_scene_occluded on the analytic Cornell box and the sphere-lamp
    box: the triangle any-hit OR a sphere hit below rmax, equal to JAX's
    (interpret-mode K7 and K3)."""
    for kw in (dict(analytic_spheres=True),
               dict(analytic_spheres=True, sphere_lamp=True)):
        js = jlib.cornell_box(with_spheres=True, **kw)
        ps = plib.cornell_box(with_spheres=True, **kw)
        rs = np.random.default_rng(11)
        p = rs.uniform([0, 10, -200], [1000, 990, 900],
                       (300, 3)).astype(np.float32)
        d = rs.normal(size=(300, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        rmax = rs.uniform(50.0, 900.0, 300).astype(np.float32)
        jr, pr = _both(p, d)
        jocc = jtk.make_scene_occluded(js, interpret=True)(
            jr, jnp.asarray(rmax))
        occ = tk.make_scene_occluded(ps)(pr, torch.from_numpy(rmax))
        np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
        assert 0 < int(occ.sum()) < 300


def test_limits_and_refusals():
    _, pt = _scene(600)
    with pytest.raises(ValueError, match="MAX_GROUPS"):
        tk.make_tilecull_intersect(pt, gs=8)
    big = plib.cornell_box(with_spheres=True, sphere_res=(80, 60))
    assert big.tris.count > 128 * tk.MAX_GROUPS
    assert tk.make_scene_occluded(big) is None
