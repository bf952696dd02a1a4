"""K12's skip rule (csrc/pair_vpu.cu), on the CPU.

The kernel skips, per pair, a sub-block of SUB consecutive cluster rows
when the ray's segment P + s D, 0 <= s <= best, misses the sub-block's box
of `sorted_intersect.pair_sub_boxes` widened by I = A + Gp |P|_1, with the
slab test rounded outward (CUDA's __fadd_rd/_ru, __fmul_rd/_ru and
__frcp_rd/_ru, emulated here exactly: float32 sums and products are exact
in float64 up to a TwoSum error term, reciprocals are checked by an exact
product; the mirror is tests/sub_cull_mirror.py, shared with K17's and
K7's tests). These tests hold that mirror to the rule's promise: no
(pair, triangle) that K1's exact test (`intersect_kernel.exact_test`)
accepts with t below the running best is ever skipped. The rays are
`stress_scene(1200)`'s: aimed at triangle corners, along edges, grazing
planes (tests/march_lanes.py), aimed at the sub-blocks' box faces and
corners, and special values (zero, subnormal and infinite components,
D = 0), with hypothesis for random rays at random scales. Then a plain
twin of the kernel's loop (sub-blocks in order, the box test against the
running best, the exact test merged with a strict < lane by lane or, as
the warp-cooperative path does, per sub-block) against `pairs_plain` on
small packs, and the table's treatment of degenerate rows.
"""

import numpy as np
import pytest
import torch

from march_lanes import aimed_rays, grazing_rays
from sub_cull_mirror import (BIG32, F32, accepted, add_dir, box_maybe,
                             cull_ray, mirrored_pairs, mul_dir, rcp_dir)
from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

CS = 128
N_TRIS = 1200


# ---------------------------------------------------------------------
# Scenes and rays.

_CACHE = {}


def packs():
    """stress_scene(1200)'s clusters of CS (rows with the dummy cluster
    appended), their table, and the triangles."""
    if not _CACHE:
        tris = library.stress_scene(N_TRIS).tris
        cscene, c, k = ck.build_clusters(tris, CS)
        rows = torch.cat([cscene.rows(), torch.zeros((k, 24))])
        _CACHE.update(tris=tris, rows=rows, c=c, k=k,
                      sub=si.pair_sub_boxes(rows, k).numpy())
    return _CACHE


def rays_at_boxes(sub, n, seed):
    """(8, n) rays from inside the stress box aimed at the faces, edges
    and corners of the sub-blocks' boxes (float32-rounded targets)."""
    rs = np.random.default_rng(seed)
    fin = np.isfinite(sub[:, :3]).all(1) & (sub[:, 0] <= sub[:, 4])
    b = sub[fin][rs.integers(0, int(fin.sum()), n)].astype(np.float64)
    lo, hi = b[:, 0:3], b[:, 4:7]
    w = rs.uniform(0, 1, (n, 3))
    w[np.arange(n), rs.integers(0, 3, n)] = rs.integers(0, 2, n)
    w[::3] = rs.integers(0, 2, (w[::3].shape[0], 3))   # corners
    tgt = lo + w * (hi - lo)
    p = np.stack([rs.uniform(-90, 1090, n), rs.uniform(10, 990, n),
                  rs.uniform(-990, 990, n)], 1)
    d = tgt - p
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r8 = np.zeros((8, n), F32)
    r8[0:3], r8[3:6] = p.T, d.T
    return r8


def special_rays(tris, seed):
    """Rays with zero, subnormal and infinite components and D = 0, some
    still aimed at triangles."""
    base = aimed_rays(64, seed, tris)
    out = [base]
    for val in (0.0, 1e-42, -1e-42, np.inf, -np.inf):
        for row in range(6):
            r = base.copy()
            r[row, ::2] = val
            out.append(r)
    z = base.copy()
    z[3:6] = 0.0
    out.append(z)
    tiny = base.copy()
    tiny[3:6] *= F32(2.0 ** -70)       # outside the rule's ranges
    out.append(tiny)
    far = base.copy()
    far[0:3] *= F32(2.0 ** 66)
    out.append(far)
    return np.concatenate(out, 1)


def check_never_skips(r8, clusters=None):
    """For every ray and cluster (all, or the given ids), every triangle
    the exact test accepts with t < BIG keeps its sub-block with best the
    next float above t (the least best for which the hit must stay).
    Returns (accepted hits checked, sub-block tests that skipped)."""
    d = packs()
    rows, k, sub = d["rows"], d["k"], d["sub"]
    nsb = -(-k // si.SUB)
    cr = cull_ray(r8[0:3], r8[3:6])
    hits = skipped = 0
    for ci in (range(d["c"]) if clusters is None else clusters):
        t, ok = accepted(rows, k, ci, r8)
        good = ok & (t < BIG32)
        boxes = sub[ci * nsb:(ci + 1) * nsb, :, None]     # (nsb, 8, 1)
        sb = np.arange(k) // si.SUB
        js, ls = np.nonzero(good)
        if js.size:
            best = np.nextafter(t[js, ls], F32(np.inf))
            crl = tuple(x[..., ls] for x in cr)
            keep = box_maybe(crl, np.moveaxis(boxes[sb[js], :, 0], 0, -1),
                             best)
            assert keep.all(), (ci, js[~keep][:5], ls[~keep][:5])
            hits += js.size
        skipped += int((~box_maybe(cr, boxes, BIG32)).sum())
    return hits, skipped


# ---------------------------------------------------------------------

def test_directed_roundings_bracket_the_exact_values():
    rs = np.random.default_rng(3)
    a = (rs.normal(size=20000) * 2.0 ** rs.integers(-60, 60, 20000)).astype(F32)
    b = (rs.normal(size=20000) * 2.0 ** rs.integers(-60, 60, 20000)).astype(F32)
    from fractions import Fraction
    for i in range(0, 20000, 97):
        x, y = Fraction(float(a[i])), Fraction(float(b[i]))
        for fn, exact in ((add_dir, x + y), (mul_dir, x * y)):
            lo = Fraction(float(fn(a[i:i + 1], b[i:i + 1], False)[0]))
            hi = Fraction(float(fn(a[i:i + 1], b[i:i + 1], True)[0]))
            assert lo <= exact <= hi
            assert float(np.nextafter(F32(lo), F32(np.inf))) >= exact
        if b[i] != 0:
            lo = Fraction(float(rcp_dir(b[i:i + 1], False)[0]))
            hi = Fraction(float(rcp_dir(b[i:i + 1], True)[0]))
            assert lo <= 1 / y <= hi
            assert Fraction(float(np.nextafter(F32(lo), F32(np.inf)))) > 1 / y
            assert Fraction(float(np.nextafter(F32(hi), F32(-np.inf)))) < 1 / y


def test_table_covers_the_scene_and_marks_degenerate_rows():
    d = packs()
    sub, k, c = d["sub"], d["k"], d["c"]
    nsb = -(-k // si.SUB)
    assert sub.shape == ((c + 1) * nsb, 8) and sub.dtype == F32
    # The dummy cluster (zero rows) is empty: always skipped.
    dummy = sub[c * nsb:]
    assert np.isposinf(dummy[:, 0:3]).all() and np.isneginf(dummy[:, 4:7]).all()
    # Every real sub-block is finite here, and boxes of neighbouring
    # triangles (Morton order) are small against the scene.
    real = sub[:c * nsb]
    live = np.isfinite(real[:, 0:3]).all(1)
    assert live.mean() > 0.9
    ext = (real[live, 4:7] - real[live, 0:3]).max(1)
    assert np.median(ext) < 0.1 * 1200.0
    # The widening is small: I at |P|_1 = 3000 under a unit.
    assert np.median(real[live, 3] + real[live, 7] * 3000.0) < 1.0
    # Degenerate rows: a zero row, a collinear triangle, a huge one.
    rows = d["rows"][:2 * k].clone()
    rows[5] = 0.0                                    # n = 0: left out
    rows[k + 3, 4:7] = rows[k + 3, 8:11]             # m1 = m2: no triangle
    rows[k + 40, 0] = 2.0 ** 40                      # outside the ranges
    t2 = si.pair_sub_boxes(rows, k).numpy()
    assert np.isfinite(t2[0, 0:3]).all()
    for sbi in (nsb, nsb + 1):
        assert np.isneginf(t2[sbi, 0:3]).all() and np.isposinf(t2[sbi, 3])
    assert np.isfinite(t2[nsb + 2, 0:3]).all()


def _cluster_order(tris):
    """build_clusters' row order (the stable Morton order of centroids),
    checked against its rows."""
    from opencl_path_tracer_tpu_torch.accel.lbvh import morton3
    r1, r2, r3 = (getattr(tris, f).numpy() for f in ("r1", "r2", "r3"))
    lo = np.minimum(np.minimum(r1, r2), r3)
    hi = np.maximum(np.maximum(r1, r2), r3)
    mid = (r1 + r2 + r3) / F32(3.0)
    ext = np.maximum(hi.max(0) - lo.min(0), F32(1e-9))
    codes = morton3((mid - lo.min(0)) / ext)
    order = np.argsort(codes.astype(np.uint32), kind="stable")
    rows = packs()["rows"].numpy()
    assert np.array_equal(rows[:len(order)],
                          k1.build_tri_pack(tris).numpy()[order])
    return order


@pytest.mark.parametrize("kind", ["aimed", "grazing", "boxes"])
def test_rule_never_skips_an_accepted_hit(kind):
    d = packs()
    r8 = {"aimed": lambda: aimed_rays(512, 11, d["tris"]),
          "grazing": lambda: grazing_rays(d["tris"], 512, 12),
          "boxes": lambda: rays_at_boxes(d["sub"], 512, 13)}[kind]()
    hits, skipped = check_never_skips(r8)
    assert hits > 50
    # The rule is not vacuous: most (ray, sub-block) tests skip.
    assert skipped > 0.5 * r8.shape[1] * d["sub"].shape[0]


def test_rule_on_special_values():
    d = packs()
    r8 = special_rays(d["tris"], 21)
    hits, _ = check_never_skips(r8)
    assert hits > 20
    # Rays with a non-finite component or D = 0 are never accepted below
    # BIG, so any decision of the rule is right for them.
    bad = ~np.isfinite(r8[:6]).all(0) | ~(r8[3:6] != 0).any(0)
    rows, k = d["rows"], d["k"]
    for ci in range(d["c"]):
        t, ok = accepted(rows, k, ci, r8[:, bad])
        assert not (ok & (t < BIG32)).any()
    # Rays outside the rule's ranges widen every box to infinity.
    cr = cull_ray(r8[0:3], r8[3:6])
    assert np.isposinf(cr[3][-128:]).all()
    live = np.isfinite(d["sub"][:, 0:3]).all(1) & (
        d["sub"][:, 0] <= d["sub"][:, 4])
    assert box_maybe(tuple(x[..., -128:] for x in cr),
                     d["sub"][live][:, :, None], BIG32).all()


def test_rule_hypothesis():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies
    d = packs()
    tris = d["tris"]
    r1, r2, r3 = (getattr(tris, f).numpy().astype(np.float64)
                  for f in ("r1", "r2", "r3"))
    rows, k, sub = d["rows"], d["k"], d["sub"]
    nsb = -(-k // si.SUB)
    order = _cluster_order(tris)
    where = np.empty(len(order), np.int64)
    where[order] = np.arange(len(order))

    @hypothesis.settings(max_examples=300, deadline=None,
                         suppress_health_check=list(
                             hypothesis.HealthCheck))
    @hypothesis.given(tri=st.integers(0, tris.count - 1),
                      bary=st.tuples(st.floats(-0.01, 1.01),
                                     st.floats(-0.01, 1.01)),
                      dist=st.floats(1e-3, 3000.0),
                      dscale=st.integers(-40, 30),
                      off=st.tuples(*[st.floats(-1, 1)] * 3),
                      tilt=st.floats(0.0, 1.0))
    def prop(tri, bary, dist, dscale, off, tilt):
        u, v = bary
        tgt = r1[tri] + u * (r2[tri] - r1[tri]) + v * (r3[tri] - r1[tri])
        nrm = np.cross(r2[tri] - r1[tri], r3[tri] - r1[tri])
        nrm /= max(np.linalg.norm(nrm), 1e-30)
        o = np.asarray(off)
        o = o / max(np.linalg.norm(o), 1e-12)
        # From a point `dist` away, between grazing (tilt 0: in the plane)
        # and head-on (tilt 1).
        o = o - (o @ nrm) * nrm * (1.0 - tilt) + nrm * tilt
        o /= max(np.linalg.norm(o), 1e-12)
        p = tgt + dist * o
        dd = (tgt - p) / dist * 2.0 ** dscale
        r8 = np.zeros((8, 1), F32)
        r8[0:3, 0], r8[3:6, 0] = p, dd
        g = where[tri]
        ci = int(g // k)
        t, ok = accepted(rows, k, ci, r8)
        cr = cull_ray(r8[0:3], r8[3:6])
        for j in np.nonzero(ok[:, 0] & (t[:, 0] < BIG32))[0]:
            box = sub[ci * nsb + j // si.SUB][:, None]
            best = np.nextafter(t[j], F32(np.inf))
            assert box_maybe(cr, box, best).all()

    prop()


@pytest.mark.parametrize("kind", ["camera", "aimed"])
def test_mirrored_loop_equals_pairs_plain(kind):
    d = packs()
    rows, k, c, sub = d["rows"], d["k"], d["c"], d["sub"]
    if kind == "camera":
        cam = library.cornell_camera(24, 16)
        from opencl_path_tracer_tpu_torch.ops import raygen, rng
        s1, u1 = rng.lehmer_step(rng.seed_pixel_streams(24 * 16, 1))
        _, u2 = rng.lehmer_step(s1)
        rays = raygen.camera_rays(cam, raygen.pixel_ids(24, 16, "cpu"), u1,
                                  u2)
        r8 = k1.pack_rays(rays.p, rays.d).numpy()
    else:
        r8 = aimed_rays(384, 31, d["tris"])
    # Each ray against its two nearest candidate clusters (K9's plain
    # version), sorted by key with dummy pairs, as a pairs round.
    boxes_r = torch.zeros((-(-c // 128) * 128, 8))
    boxes_r[:c] = ck.build_clusters(d["tris"], CS)[0].boxes
    ids = si.candidates_plain(torch.from_numpy(r8), boxes_r, 2, c)[0]
    from opencl_path_tracer_tpu_torch.ops.kernels import pair_mxu
    keys_s, r8p, _ = pair_mxu.sort_pairs(
        [torch.from_numpy(r8[j]) for j in range(6)], ids, c, 256)
    plain = si.pairs_plain(keys_s, r8p, rows, k).numpy()
    real = int((keys_s < c).sum())
    for warp in (False, True):
        t, g, n_div, n_box = mirrored_pairs(keys_s.numpy(), r8p.numpy(),
                                            rows, k, sub, warp)
        assert np.array_equal(t.view(np.int32), plain[0].view(np.int32))
        hit = t < BIG32
        attrs = rows.numpy()[g][:, [0, 1, 2, 16]] + F32(0.0)
        attrs[~hit] = 0.0
        assert np.array_equal(attrs.T.view(np.int32),
                              plain[1:].view(np.int32))
        assert hit.sum() > 20
        # The skip rule leaves under half of every pair x every row.
        assert n_div < 0.5 * real * k and n_box < real * (-(-k // si.SUB))
