"""K1's rejections before the divide (csrc/minarg.cu), on the CPU.

The kernel computes num = c0 - n.P and vn = n.D as nearest.cuh does and
skips the divide t = RN(num / vn) where t certainly fails t > 0 or the
strict t < best: (a) num and vn not of one strict sign, or (b)
|num| >= RU(best |vn|), the product rounded up (CUDA's __fmul_ru). These
tests check that no (num, vn, best) triple is rejected whose t would
pass both, with __fmul_ru emulated exactly (a float32 product is exact in
float64, then rounded up to float32): on random and adversarial triples
(subnormals, +-0, inf, NaN, best = RN(num / vn) and its neighbours,
best = BIG), on every combination of special values, and with
hypothesis where it is installed. Then a plain twin of the kernel's
loops, the per-warp choice of the joint loop included (this file only),
against minarg_plain on the Cornell and reference packs, on two rows of
their 1080p camera rays and on tests/minarg_rays.py's adversarial batch,
with a pack whose rows repeat (exact t ties).
"""

import pathlib

import numpy as np
import pytest
import torch

from minarg_rays import KINDS, adversarial_rays, tie_pack
from sub_cull_mirror import ABOVE_BIG_CASES, crafted_dense
from opencl_path_tracer_tpu_torch.ops import raygen, rng
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    BIG, _dot3,
)
from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

MODELS = str(pathlib.Path(__file__).resolve().parent / "assets" / "models")
F32 = np.float32
BIG32 = F32(BIG)


def fmul_ru(a, b):
    """CUDA's __fmul_ru on float32 arrays: the exact product (float64
    holds it), rounded up to float32."""
    x = a.astype(np.float64) * b.astype(np.float64)
    with np.errstate(over="ignore", invalid="ignore"):
        f = x.astype(F32)
        return np.where(f.astype(np.float64) < x,
                        np.nextafter(f, F32(np.inf)), f)


def may_be_nearer(num, vn, best):
    """The kernel's test: False only where t = RN(num / vn) certainly
    fails t > 0 or t < best. s is num with vn's sign bit applied."""
    s = np.where(np.signbit(vn), -num, num)
    with np.errstate(invalid="ignore"):
        return (s > 0) & (s < fmul_ru(best, np.abs(vn)))


def passes(num, vn, best):
    """What the divide would decide: t > 0 and t < best."""
    with np.errstate(all="ignore"):
        t = num / vn
        return (t > 0) & (t < best)


def check(num, vn, best):
    num, vn, best = (np.asarray(x, F32) for x in (num, vn, best))
    keep = may_be_nearer(num, vn, best)
    bad = passes(num, vn, best) & ~keep
    assert not bad.any(), (num[bad][:5], vn[bad][:5], best[bad][:5])
    return keep


def wide_floats(rs, n, lo=-149, hi=127):
    """float32 values of either sign with exponents in [lo, hi] (so
    subnormals near the bottom), a few +-0, inf and NaN."""
    m = rs.uniform(1.0, 2.0, n) * rs.choice([-1.0, 1.0], n)
    with np.errstate(over="ignore"):
        x = (m * 2.0 ** rs.integers(lo, hi + 1, n)).astype(F32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan,
                        1e-45, -1e-45, 1.1754942e-38], F32)
    pick = rs.random(n) < 0.05
    x[pick] = rs.choice(special, int(pick.sum()))
    return x


@pytest.mark.parametrize("seed", range(4))
def test_rule_b_never_rejects_a_nearer_t(seed):
    rs = np.random.default_rng(seed)
    n = 200_000
    num, vn = wide_floats(rs, n), wide_floats(rs, n)
    with np.errstate(all="ignore"):
        t = (num / vn).astype(F32)
    # best: BIG, random, and RN(num / vn) with its neighbours (where t is
    # a positive finite float32, the boundary of the strict <).
    ok = np.isfinite(t) & (t > 0)
    cases = [np.full(n, BIG32), np.abs(wide_floats(rs, n, -149, 127))]
    tb = np.where(ok, t, F32(1.0))
    cases += [tb, np.nextafter(tb, F32(np.inf)), np.nextafter(tb, F32(0)),
              np.nextafter(np.nextafter(tb, F32(np.inf)), F32(np.inf))]
    kept = rejected_ge = 0
    for best in cases:
        best = np.where((best > 0) & np.isfinite(best) & (best <= BIG32),
                        best, BIG32)
        keep = check(num, vn, best)
        kept += int(keep.sum())
        with np.errstate(all="ignore"):
            ge = (num / vn >= best) & (np.signbit(num) == np.signbit(vn))
        rejected_ge += int((ge & ~keep).sum())
    # The rule is not vacuous: it rejects most pairs whose t >= best.
    assert rejected_ge > 0 and kept > 0


def test_rule_b_on_the_boundary():
    """t = best exactly (rejected or not, the strict < fails), one ulp
    above (must be kept), for products near the subnormal range and near
    overflow, and best = BIG against tiny and huge |vn|."""
    rs = np.random.default_rng(7)
    n = 50_000
    for lo, hi in ((-149, -100), (-30, 30), (60, 127)):
        num = wide_floats(rs, n, lo, hi)
        vn = wide_floats(rs, n, -40, 40)
        with np.errstate(all="ignore"):
            t = (num / vn).astype(F32)
        ok = np.isfinite(t) & (t > 0) & (t < BIG32)
        num, vn, t = num[ok], vn[ok], t[ok]
        check(num, vn, t)
        up = np.nextafter(t, F32(np.inf))
        keep = check(num, vn, up)
        assert keep[up <= BIG32].all()
    check(np.float32([1e-45, 3e38, 1.0, -1.0]), np.float32(
        [1e-45, 1e-45, 3e38, -1e-45]), np.full(4, BIG32))


def _special_values():
    """+-0, +-inf, NaN, the least subnormal, the least normal, 1, BIG,
    the largest float, a few subnormals, each with its neighbours."""
    base = np.float32([0.0, 1e-45, 1e-40, 1.1754942e-38, 2.0 ** -100, 0.5,
                       1.0, 3.0, 2.0 ** 64, 1e30, 3e38, 3.4028235e38])
    with np.errstate(over="ignore"):
        near = [base, np.nextafter(base, F32(np.inf)),
                np.nextafter(base, F32(0))]
    pos = np.unique(np.concatenate(near))
    return np.concatenate([pos, -pos, np.float32([np.inf, -np.inf,
                                                   np.nan])])


def test_rule_b_on_special_values():
    """Every (num, vn, best) of special values (best among the positive
    ones up to BIG), and best = RN(num / vn) with its neighbours."""
    v = _special_values()
    b = v[(v > 0) & (v <= BIG32)]
    num, vn, best = (x.ravel() for x in np.meshgrid(v, v, b, indexing="ij"))
    keep = check(num, vn, best)
    assert keep.any() and not keep.all()
    num, vn = (x.ravel() for x in np.meshgrid(v, v, indexing="ij"))
    with np.errstate(all="ignore"):
        t = (num / vn).astype(F32)
    ok = np.isfinite(t) & (t > 0) & (t < BIG32)
    num, vn, t = num[ok], vn[ok], t[ok]
    check(num, vn, t)
    up = np.nextafter(t, F32(np.inf))
    assert check(num, vn, up)[up <= BIG32].all()
    check(num, vn, np.nextafter(t, F32(0)))


def test_rule_b_hypothesis():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies
    finite32 = st.floats(width=32, allow_nan=True, allow_infinity=True)
    best32 = st.floats(min_value=float(F32(1e-45)), max_value=float(BIG32),
                       width=32, allow_subnormal=True)

    @hypothesis.settings(max_examples=3000, deadline=None,
                         derandomize=True, database=None)
    @hypothesis.given(num=finite32, vn=finite32, best=best32)
    def rule_b(num, vn, best):
        check([num], [vn], [best])
        with np.errstate(all="ignore"):
            t = F32(num) / F32(vn)
        if np.isfinite(t) and 0 < t < BIG32:
            check([num], [vn], [t])
            check([num], [vn], [np.nextafter(t, F32(np.inf))])

    rule_b()


def _may_be_nearer_torch(num, vn, best):
    s = torch.where(torch.signbit(vn), -num, num)
    x = best.double() * vn.abs().double()
    f = x.float()
    f = torch.where(f.double() < x, torch.nextafter(f, torch.tensor(
        float("inf"))), f)
    return (s > 0) & (s < f)


BLOCK, RAYS, JOINT_SPREAD = 256, 2, 1.0


def joint_warps(rays8):
    """Per ray of the (8, R) pack, whether its warp runs the joint loop,
    and the number of such warps. Ray i of block b is (2 b + r) 256 +
    thread, r = 0, 1; a warp is 32 threads with their two rays each, the
    tail padded with zero rays as the kernel masks it. A warp runs the
    joint loop where its unit directions (zero and non-finite ones left
    out) spread by JOINT_SPREAD or more on some axis. (Computed here in
    float64, the kernel's rsqrtf aside: near the threshold the two may
    choose differently, which moves no output bit.)"""
    r = rays8.shape[1]
    per = RAYS * BLOCK
    rp = -(-r // per) * per
    d = torch.cat([rays8[3:6], torch.zeros((3, rp - r))], 1).double()
    u = d / d.norm(dim=0)
    u = torch.where(torch.isfinite(u).all(0), u, float("nan"))
    u = u.view(3, rp // per, RAYS, BLOCK // 32, 32)     # block, slot, warp
    hi = torch.where(u.isnan(), -torch.inf, u).amax((2, 4))
    lo = torch.where(u.isnan(), torch.inf, u).amin((2, 4))
    wide = ((hi - lo) >= JOINT_SPREAD).any(0)            # (blocks, warps)
    per_ray = wide[:, None, :, None].expand(rp // per, RAYS, BLOCK // 32,
                                            32).reshape(rp)[:r]
    return per_ray, int(wide.sum())


def minarg_culled(rays8, pack):
    """The loops of csrc/minarg.cu written out in PyTorch, one triangle
    at a time over all rays, then the step of csrc/argmin_start.cuh (a
    ray whose triangle 0 accepts it above BIG takes the reference's
    argmin, every row competing with t where it accepts and BIG
    elsewhere): (t, g) as minarg_plain gives them, the pairs that reached
    the divide, and the warps that ran the joint loop (no cull: every pair
    divided)."""
    r = rays8.shape[1]
    p = (rays8[0], rays8[1], rays8[2])
    d = (rays8[3], rays8[4], rays8[5])
    best = torch.full((r,), BIG, dtype=torch.float32)
    g = torch.zeros(r, dtype=torch.float32)
    joint, warps = joint_warps(rays8)
    reached = 0
    for j in range(pack.shape[0]):
        c = pack[j]
        n = (c[0], c[1], c[2])
        vn = _dot3(n, d)
        num = c[3] - _dot3(n, p)
        may = _may_be_nearer_torch(num, vn, best) | joint
        if not bool(may.any()):
            continue
        idx = torch.nonzero(may).flatten()
        reached += idx.numel()
        t = num[idx] / vn[idx]
        ok = (t > 0) & (t < best[idx])
        for b in (4, 8, 12):
            m = (c[b], c[b + 1], c[b + 2])
            pm = _dot3(m, tuple(x[idx] for x in p))
            vm = _dot3(m, tuple(x[idx] for x in d))
            ok &= fp.fma(t, vm, pm) >= c[b + 3]
        best[idx[ok]] = t[ok]
        g[idx[ok]] = float(j)
    t, ok = k1.exact_test(pack, rays8)
    above = ok[0] & (t[0] > BIG)
    tm, gm = torch.min(torch.where(ok, t, torch.full_like(t, BIG)), dim=0)
    best = torch.where(above, tm, best)
    g = torch.where(above, gm.to(torch.float32), g)
    return best, g, reached, warps


def _camera_rays(cam):
    """Rays of two rows of a 1920x1080 camera, 1,024 pixels each: warps
    of 32 neighbouring pixels, as coherent as the kernel meets them."""
    ids = torch.cat([torch.arange(1024, dtype=torch.int32) + y * 1920
                     for y in (540, 541)])
    s1, r1 = rng.lehmer_step(rng.seed_pixel_streams(ids.numel(), 1))
    _, r2 = rng.lehmer_step(s1)
    rays = raygen.camera_rays(cam, ids, r1, r2)
    return k1.pack_rays(rays.p, rays.d).contiguous()


def _scene(name):
    if name == "cornell":
        scene = library.cornell_box(with_spheres=True)
        return scene.tris, _camera_rays(library.cornell_camera(1920, 1080))
    scene = library.reference_scene(MODELS, smooth=True)
    return scene.tris, _camera_rays(library.reference_camera(1920, 1080))


@pytest.mark.parametrize("name", ["cornell", "reference"])
def test_culled_loop_equals_minarg_plain(name):
    tris, cam8 = _scene(name)
    pack = k1.build_tri_pack(tris)
    adv = torch.as_tensor(adversarial_rays(tris, 64 * KINDS, 5))
    joint, share = [], []
    for rays8, tpack in ((cam8, pack), (adv, pack),
                         (adv[:, :16 * KINDS].contiguous(), tie_pack(pack))):
        t, g, reached, warps = minarg_culled(rays8, tpack)
        tp, gp = k1.minarg_plain(rays8, tpack)
        assert torch.equal(t, tp) and torch.equal(g, gp)
        hits = tp < BIG
        assert bool(hits.any())
        joint.append(warps)
        share.append(reached / (rays8.shape[1] * tpack.shape[0]))
    # The camera rays' warps keep the cull, which settles a share of their
    # pairs before the divide; the adversarial batch (eight kinds of ray
    # in turn across the lanes) takes the joint loop.
    assert joint[0] == 0 and share[0] < 0.7
    assert joint[1] > 0
    # The adversarial batch meets ties: on the repeated pack a hit's twin
    # has the same t, and the lower index wins.
    t2, g2 = k1.minarg_plain(adv, tie_pack(pack))
    hit = t2 < BIG
    assert bool(hit.any()) and bool((g2[hit] < pack.shape[0]).all())


@pytest.mark.parametrize("n_rows,n_deg", ABOVE_BIG_CASES)
def test_culled_loop_follows_reference_above_big(n_rows, n_deg):
    """On tests/sub_cull_mirror.py's crafted batches, whose first n_deg
    rows accept some rays above BIG, the kernel's loops with the step of
    csrc/argmin_start.cuh give minarg_plain's (t, g): such a ray misses
    at (BIG, n_deg), the first row that does not accept it, where the
    loops alone keep (BIG, 0)."""
    tris = library.cornell_box(with_spheres=True).tris
    pack, r8 = crafted_dense(tris, n_rows, n_deg)
    rays8 = torch.from_numpy(r8)
    t, g, _, _ = minarg_culled(rays8, pack)
    tp, gp = k1.minarg_plain(rays8, pack)
    assert torch.equal(t, tp) and torch.equal(g, gp)
    tt, ok = k1.exact_test(pack, rays8)
    above = ok[0] & (tt[0] > BIG)
    assert int(above.sum()) > 10
    assert (gp[above & (tp == BIG)] == float(n_deg)).all()
