"""An exact float32 mirror of the sub-block skip rule's slab test
(csrc/sub_cull.cuh: cull_ray, box_maybe) and of the loops that K12
(csrc/pair_vpu.cu), K17 (csrc/cluster.cu), K7 (csrc/anyhit.cu), K6
(csrc/tilecull.cu), K16 (csrc/group.cu), K14 (csrc/minarg_fused.cu) and
K15 (csrc/mxu.cu) run over it, on the CPU, and a crafted batch for K14
and K15. Shared by tests/test_torch_pair_vpu_cull.py,
test_torch_cluster_cull.py, test_torch_anyhit_cull.py,
test_torch_tilecull_cull.py, test_torch_group_cull.py,
test_torch_dense_cull.py and test_torch_cuda.py.

CUDA's directed roundings (__fadd_rd/_ru, __fmul_rd/_ru, __frcp_rd/_ru)
are emulated exactly: float32 sums and products are exact in float64 up
to a TwoSum error term, reciprocals are checked by an exact product. The
loops test the rows with K1's exact test (`intersect_kernel.exact_test`,
the kernels' arithmetic op for op; K15's loop with
`intersect_kernel.mxu_exact_test`) and merge as the kernels do: lane by
lane (a strict < in ascending row order, each lane its own ray) or, as
the warp-cooperative path does, per sub-block (the sub-block's least
(t, index) first, then a strict <), chosen per warp of 32 rays by the
size of its ballot as the kernels choose.
"""

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.ops.kernels import tilecull_kernel as tk
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import BIG

F32 = np.float32
BIG32 = F32(BIG)
SUB = ck.SUB


# ---------------------------------------------------------------------
# CUDA's directed roundings of float32, exactly.

def _step(f, up):
    return np.nextafter(f, F32(np.inf) if up else F32(-np.inf))


def add_dir(a, b, up):
    """__fadd_ru (up) or __fadd_rd of float32 arrays."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    with np.errstate(all="ignore"):
        s = a64 + b64
        bb = s - a64
        e = (a64 - (s - bb)) + (b64 - bb)      # a + b = s + e exactly
        f = s.astype(F32)
        f64 = f.astype(np.float64)
        move = (f64 < s) | ((f64 == s) & (e > 0)) if up else (
            (f64 > s) | ((f64 == s) & (e < 0)))
        move &= np.isfinite(s)
    return np.where(move, _step(f, up), f)


def mul_dir(a, b, up):
    """__fmul_ru (up) or __fmul_rd: the exact product, rounded."""
    with np.errstate(all="ignore"):
        x = a.astype(np.float64) * b.astype(np.float64)
        f = x.astype(F32)
        f64 = f.astype(np.float64)
        move = (f64 < x) if up else (f64 > x)
    return np.where(move, _step(f, up), f)


def rcp_dir(d, up):
    """__frcp_ru (up) or __frcp_rd: the float32 just above (below) 1/d,
    decided by the exact product q d against 1."""
    d64 = d.astype(np.float64)
    with np.errstate(all="ignore"):
        q = (1.0 / d64).astype(F32)

        def above(x):       # x > 1/d exactly
            return (x.astype(np.float64) * d64 - 1.0) * np.sign(d64) > 0

        def below(x):
            return (x.astype(np.float64) * d64 - 1.0) * np.sign(d64) < 0

        fin = np.isfinite(d64) & (d64 != 0)
        if up:
            q = np.where(fin & below(q), _step(q, True), q)
            q = np.where(fin & ~below(_step(q, False)), _step(q, False), q)
        else:
            q = np.where(fin & above(q), _step(q, False), q)
            q = np.where(fin & ~above(_step(q, True)), _step(q, True), q)
    return q


# ---------------------------------------------------------------------
# The rule, as the kernel computes it (cull_ray, box_maybe).

def cull_ray(p, d):
    """(P, rlo, rhi, |P|_1 rounded up or inf): p, d (3, R) float32."""
    rlo, rhi = rcp_dir(d, False), rcp_dir(d, True)
    # fmaxf drops NaN: the kernel's maxima skip a NaN component.
    ap, ad = np.fmax.reduce(np.abs(p), 0), np.fmax.reduce(np.abs(d), 0)
    with np.errstate(invalid="ignore"):
        ok = (ap <= 2.0 ** 64) & (ad <= 2.0 ** 40) & (ad >= 2.0 ** -64)
    a = np.abs(p)
    pn = add_dir(add_dir(a[0], a[1], True), a[2], True)
    return p, rlo, rhi, np.where(ok, pn, F32(np.inf))


def box_maybe(cr, box, best):
    """The kernel's box_maybe, broadcast over (..., R): box (..., 8)
    [lo A hi Gp] with a trailing ray axis, best (..., R)."""
    p, rlo, rhi, pn = cr
    lo, hi = box[..., 0:3, :], box[..., 4:7, :]
    widen = add_dir(box[..., 3, :], mul_dir(box[..., 7, :], pn, True), True)
    smin = np.zeros(np.broadcast(widen, best).shape, F32)
    smax = np.broadcast_to(best, smin.shape).astype(F32)
    for i in range(3):
        a = add_dir(add_dir(lo[..., i, :], -widen, False), -p[i], False)
        b = add_dir(add_dir(hi[..., i, :], widen, True), -p[i], True)
        neg = np.signbit(rlo[i])
        x, y = np.where(neg, b, a), np.where(neg, a, b)
        lower = mul_dir(x, np.where(x < 0, rhi[i], rlo[i]), False)
        upper = mul_dir(y, np.where(y < 0, rlo[i], rhi[i]), True)
        with np.errstate(invalid="ignore"):
            smin = np.fmax(smin, lower)     # fmaxf: NaN dropped
            smax = np.fmin(smax, upper)
    return smin <= smax


# ---------------------------------------------------------------------
# The kernels' loops.

def accepted(rows, k, ci, r8):
    """K1's exact test of the rays r8 (8, R) against cluster ci: (t, ok),
    (k, R) each."""
    t, ok = k1.exact_test(rows[ci * k:(ci + 1) * k], torch.from_numpy(r8))
    return t.numpy(), ok.numpy()


def merge_sub_block(t, ok, go, bt, bg, j0, warp):
    """One sub-block (rows j0.. of t, ok: (n, R)) merged into the running
    (bt, bg) for the rays where go: lane by lane in ascending order with a
    strict <, or, where warp (bool or (R,) bool), the sub-block's least
    (t, index) first, then a strict <. Returns the new (bt, bg)."""
    tm = np.where(ok, t, F32(np.inf))
    jm = tm.argmin(0)                            # first index at the min
    tmin = tm[jm, np.arange(tm.shape[1])]
    win_w = go & warp & (tmin < bt)
    lane_t, lane_g = bt.copy(), bg.copy()
    for j in range(t.shape[0]):
        win = go & ok[j] & (t[j] < lane_t)
        lane_t = np.where(win, t[j], lane_t)
        lane_g = np.where(win, j0 + j, lane_g)
    bt2 = np.where(warp, np.where(win_w, tmin, bt), lane_t)
    bg2 = np.where(warp, np.where(win_w, j0 + jm, bg), lane_g)
    return bt2, bg2


def warp_ballots(go, coop):
    """(R,) bool: the rays whose warp (32 consecutive rays) runs the
    sub-block on all lanes, a ballot of at most coop rays."""
    n = go.shape[0]
    pad = np.zeros(-n % 32, bool)
    pop = np.concatenate([go, pad]).reshape(-1, 32).sum(1)
    return np.repeat(pop <= coop, 32)[:n]


def mirrored_pairs(keys, r8, rows, k, sub, warp):
    """The kernel's loop, per pair: its cluster's sub-blocks in order,
    skipped where box_maybe fails against the running best; then the
    exact test of every row of the others, merged by a strict < in
    ascending index (each lane its own pair) or, with warp=True, as the
    warp-cooperative path merges (the sub-block's least (t, index) first,
    then a strict <). Returns (t (P,), winner row (P,), tests reaching
    the divide, sub-blocks tested)."""
    nsb = -(-k // SUB)
    c = rows.shape[0] // k - 1
    p = keys.shape[0]
    best_t = np.full(p, BIG32)
    best_g = np.zeros(p, np.int64)
    n_div = n_box = 0
    cr = cull_ray(r8[0:3], r8[3:6])
    for ci in np.unique(keys):
        if not 0 <= ci < c:
            continue
        sel = np.nonzero(keys == ci)[0]
        t, ok = accepted(rows, k, ci, r8[:, sel])
        crs = tuple(x[..., sel] for x in cr)
        bt = best_t[sel]
        bg = best_g[sel]
        for s in range(nsb):
            go = box_maybe(crs, sub[ci * nsb + s][:, None], bt)
            j0, j1 = s * SUB, min(k, (s + 1) * SUB)
            n_box += int(go.sum())
            n_div += int(go.sum()) * (j1 - j0)
            bt, bg = merge_sub_block(t[j0:j1], ok[j0:j1], go, bt, bg,
                                     ci * k + j0, warp)
        best_t[sel], best_g[sel] = bt, bg
    return best_t, best_g, n_div, n_box


def mirrored_tiles(rr8, cnt, ids, entry, rows, k, tr, sub, early_exit,
                   coop):
    """K17's loop: per tile of tr rays of the (Rpad, 8) rows, its list in
    order (with early_exit, stopping before a slot whose entry is not
    below the tile's largest best), each cluster's sub-blocks in order,
    skipped where box_maybe fails against the ray's running best, merged
    as the kernel's warps choose with coop (-1: lane by lane only; 32:
    whole warp only). Returns (t (Rpad,), winner row (Rpad,), tests
    reaching the divide, box tests passed, box tests made)."""
    nsb = -(-k // SUB)
    g = rr8.shape[0] // tr
    best_t = np.full(rr8.shape[0], BIG32)
    best_g = np.zeros(rr8.shape[0], np.int64)
    n_div = n_box = n_made = 0
    for tile in range(g):
        sl = slice(tile * tr, (tile + 1) * tr)
        r8 = np.ascontiguousarray(rr8[sl].T)
        cr = cull_ray(r8[0:3], r8[3:6])
        bt, bg = best_t[sl], best_g[sl]
        for slot in range(int(cnt[tile, 0])):
            if early_exit and not entry[tile, slot] < bt.max():
                break
            ci = int(ids[tile, slot])
            t, ok = accepted(rows, k, ci, r8)
            for s in range(nsb):
                go = box_maybe(cr, sub[ci * nsb + s][:, None], bt)
                j0, j1 = s * SUB, min(k, (s + 1) * SUB)
                n_made += tr
                n_box += int(go.sum())
                n_div += int(go.sum()) * (j1 - j0)
                bt, bg = merge_sub_block(t[j0:j1], ok[j0:j1], go, bt, bg,
                                         ci * k + j0, warp_ballots(go, coop))
        best_t[sl], best_g[sl] = bt, bg
    return best_t, best_g, n_div, n_box, n_made


def mirrored_anyhit(s8, rmax, pack, groups, sub):
    """K7's loop: per ray, the groups in table order (needed where the
    slab test passes, tn <= rmax and the ray is not yet occluded; none
    where rmax is not above 0), in a needed group the sub-blocks in order,
    skipped where box_maybe fails against rmax, the ray occluded by an
    accepted t < rmax in a sub-block it tests. Returns (flags (R,), tests
    reaching the divide (every row of a tested sub-block), box tests
    passed)."""
    rays = torch.from_numpy(s8)
    inv = [tk._safe_inv(c) for c in rays[3:6]]
    cr = cull_ray(s8[0:3], s8[3:6])
    with np.errstate(invalid="ignore"):
        idle = ~(rmax > 0)
    occ = np.zeros(s8.shape[1], bool)
    n_div = n_box = 0
    sb = 0
    for row in groups.tolist():
        tn, tf = (x.numpy() for x in tk._slab(rays[0:3], inv, row[0:3],
                                             row[3:6]))
        with np.errstate(invalid="ignore"):
            need = ~idle & ~occ & (tf >= tn) & (tf >= 0) & (tn <= rmax)
        base, end = int(row[6]), int(row[7])
        t, ok = (x.numpy() for x in k1.exact_test(pack[base:end], rays))
        with np.errstate(invalid="ignore"):
            hit = ok & (t < rmax[None])
        for s in range(-(-(end - base) // SUB)):
            j0, j1 = s * SUB, min(end - base, (s + 1) * SUB)
            go = need & ~occ & box_maybe(cr, sub[sb + s][:, None], rmax)
            n_box += int(go.sum())
            n_div += int(go.sum()) * (j1 - j0)
            occ |= go & hit[j0:j1].any(0)
        sb += -(-(end - base) // SUB)
    return occ, n_div, n_box


def mirrored_tilecull(r8, pack, groups, sub, coop):
    """K6's loop: per ray, the groups in table order (needed where the
    slab test passes and tn is below the ray's best t), in a needed group
    the sub-blocks in order, skipped where box_maybe fails against the
    running best (never one past the table's end), merged as the
    kernel's warps of 32 consecutive rays choose with coop. r8 (8, R)
    float32. Returns (t (R,), winner row (R,), tests reaching the
    divide, box tests passed, slab and box tests made)."""
    rays = torch.from_numpy(r8)
    inv = [tk._safe_inv(c) for c in rays[3:6]]
    cr = cull_ray(r8[0:3], r8[3:6])
    r = r8.shape[1]
    bt = np.full(r, BIG32)
    bg = np.zeros(r, np.int64)
    n_div = n_box = n_made = 0
    sb = 0
    for row in groups.tolist():
        tn, tf = (x.numpy() for x in tk._slab(rays[0:3], inv, row[0:3],
                                             row[3:6]))
        with np.errstate(invalid="ignore"):
            need = (tf >= tn) & (tf >= 0) & (tn < bt)
        base, end = int(row[6]), int(row[7])
        t, ok = (x.numpy() for x in k1.exact_test(pack[base:end], rays))
        n_made += r
        nsb = -(-(end - base) // SUB)
        for s in range(nsb):
            j0, j1 = s * SUB, min(end - base, (s + 1) * SUB)
            go = need.copy()
            if sb + s < sub.shape[0]:
                go &= box_maybe(cr, sub[sb + s][:, None], bt)
            n_made += int(need.sum())
            n_box += int(go.sum())
            n_div += int(go.sum()) * (j1 - j0)
            bt, bg = merge_sub_block(t[j0:j1], ok[j0:j1], go, bt, bg,
                                     base + j0, warp_ballots(go, coop))
        sb += nsb
    return bt, bg, n_div, n_box, n_made


def mirrored_group(union, rr8, rows, k, block, sub, coop):
    """K16's loop: per ray of the (Rpad, 8) rows, the clusters of its
    block's union (union (G,), none for a ray with D = 0) in ascending
    order, each cluster's sub-blocks in order, skipped where box_maybe
    fails against the running best, merged as the kernel's warps of 32
    consecutive rays choose with coop. Returns (t (Rpad,), winner row
    (Rpad,), tests reaching the divide, box tests passed, box tests
    made)."""
    r8 = np.ascontiguousarray(rr8.T)
    u = np.repeat(np.asarray(union, np.int64), block)
    u = np.where((r8[3:6] != 0).any(0), u, 0)
    cr = cull_ray(r8[0:3], r8[3:6])
    nsb = -(-k // SUB)
    r = r8.shape[1]
    bt = np.full(r, BIG32)
    bg = np.zeros(r, np.int64)
    n_div = n_box = n_made = 0
    for ci in range(rows.shape[0] // k):
        take = ((u >> ci) & 1) == 1
        if not take.any():
            continue
        t, ok = accepted(rows, k, ci, r8)
        for s in range(nsb):
            j0, j1 = s * SUB, min(k, (s + 1) * SUB)
            go = take & box_maybe(cr, sub[ci * nsb + s][:, None], bt)
            n_made += int(take.sum())
            n_box += int(go.sum())
            n_div += int(go.sum()) * (j1 - j0)
            bt, bg = merge_sub_block(t[j0:j1], ok[j0:j1], go, bt, bg,
                                     ci * k + j0, warp_ballots(go, coop))
    return bt, bg, n_div, n_box, n_made


def never_skipped(n):
    """A table of n sub-blocks none of which is ever skipped (the
    infinite box): the mirrors then run every row, the first kernels'
    walk."""
    out = np.zeros((n, 8), F32)
    out[:, 0:3] = -np.inf
    out[:, 4:7] = np.inf
    out[:, 3] = np.inf
    return out


def dense_tests(r8, pack, test):
    """The exact test of K14 (test "k1") or K15 (test "mxu") of the rays
    r8 (8, R) float32 against every row of pack: (t, ok), (T, R) numpy."""
    fn = k1.mxu_exact_test if test == "mxu" else k1.exact_test
    return tuple(x.numpy() for x in fn(pack, torch.from_numpy(r8)))


def mirrored_dense(r8, pack, sub, coop, test, tested=None):
    """K14's (test "k1") or K15's (test "mxu") loop: per ray with D != 0,
    the pack's sub-blocks of SUB rows in row order, skipped where
    box_maybe fails against the running best but never while the best is
    above BIG, merged as the kernel's warps of 32 consecutive rays choose
    with coop. K1's test merges the accepted rows' t from a start of (BIG,
    0), except on a ray whose row 0 accepts it above BIG, which takes the
    reference's argmin (every row competing with tm) and tests nothing in
    the loop (csrc/argmin_start.cuh); K15's lets every row compete with tm
    (t where it accepts, BIG elsewhere) from a start of +inf. A ray with D
    = 0 tests nothing and keeps (BIG, 0). r8 (8, R) float32, pack (T, 24)
    tensor, sub (S, 8);
    tested: `dense_tests(r8, pack, test)` where the caller has it.
    Returns (t (R,), winner row (R,), tests reaching the divide, box
    tests passed, box tests made)."""
    live = (r8[3:6] != 0).any(0)
    cr = cull_ray(r8[0:3], r8[3:6])
    r, n = r8.shape[1], pack.shape[0]
    t, ok = tested if tested is not None else dense_tests(r8, pack, test)
    bg = np.zeros(r, np.int64)
    if test == "mxu":
        t, ok = np.where(ok, t, BIG32), np.ones_like(ok)
        bt = np.where(live, F32(np.inf), BIG32)
    else:
        bt = np.full(r, BIG32)
        with np.errstate(invalid="ignore"):
            above = live & ok[0] & (t[0] > BIG32)
        tm = np.where(ok[:, above], t[:, above], BIG32)
        bg[above] = tm.argmin(0)                # first index at the min
        bt[above] = tm[bg[above], np.arange(tm.shape[1])]
        live = live & ~above
    n_div = n_box = n_made = 0
    for s in range(-(-n // SUB)):
        j0, j1 = s * SUB, min(n, (s + 1) * SUB)
        go = live & ((bt > BIG32) | box_maybe(cr, sub[s][:, None], bt))
        n_made += int(live.sum())
        n_box += int(go.sum())
        n_div += int(go.sum()) * (j1 - j0)
        bt, bg = merge_sub_block(t[j0:j1], ok[j0:j1], go, bt, bg, j0,
                                 warp_ballots(go, coop))
    return bt, bg, n_div, n_box, n_made


# The crafted batches (kernel, T, degenerate rows), on the CPU
# (tests/test_torch_dense_cull.py) and on the card (chip_smoke.py,
# tests/test_torch_cuda.py). K15's have rows accepted above BIG.
CRAFTED_CASES = [("minarg_fused", t, 0) for t in (1, 31, 33, 804)] + [
    ("mxu", 1, 0), ("mxu", 1, 1), ("mxu", 31, 1), ("mxu", 33, 32),
    ("mxu", 804, 1)]
# The batches (T, degenerate rows) whose rays accept row 0 above BIG, for
# K1 and K14 (csrc/argmin_start.cuh): there they follow the reference's
# argmin, whose rows that do not accept compete with BIG, so such a miss
# takes the first row that does not accept (row n_deg). Each kernel equals
# its plain version, its first kernel and (K14) K1 + K2 on them.
ABOVE_BIG_CASES = [(31, 1), (33, 32), (804, 1)]

# Row constants of the crafted pack's degenerate rows: n = (1, -0, -0),
# c0 = 3.1e38 and m_k = 0, d_k = 0, so a ray with D_x in (0.911, 1]
# accepts them at t = (c0 - P_x) / D_x above BIG (a finite t; the edge
# tests 0 >= 0 pass), and no other ray does.
DEGENERATE_C0 = 3.1e38


def crafted_dense(tris, n_rows, n_deg, n_rays=512, seed=0):
    """(pack (n_rows, 24) CPU tensor, rays (8, n_rays) float32 numpy) for K14
    and K15: the rows of the triangles `tris` (TrianglesSoA) in turn, the
    zero normal components of every odd row made -0.0, row 1 copied into
    row 33 (exact-t ties across sub-blocks 0 and 1) where n_rows > 33,
    and the first n_deg rows degenerate (DEGENERATE_C0). Lane i's ray is
    of kind i % 6: 0 aimed at a row's centroid (row 1's one time in four);
    1 D near +x from inside the scene (it accepts the degenerate rows above
    BIG); 2 D = +x from far above the scene, missing every real row's box;
    3 D = 0 (signed zeros); 4 a random direction; 5 an axis direction with
    -0.0 components from inside the scene."""
    rs = np.random.default_rng(seed)
    base = k1.build_tri_pack(tris).cpu()
    take = np.arange(n_rows) % base.shape[0]
    pack = base[torch.as_tensor(take)].clone()
    verts = [getattr(tris, f).cpu().numpy().astype(np.float64)[take]
             for f in ("r1", "r2", "r3")]
    nrm = pack[1::2, 0:3]
    pack[1::2, 0:3] = torch.where(nrm == 0.0, torch.full_like(nrm, -0.0),
                                  nrm)
    if n_rows > 33:
        pack[33] = pack[1]
        for v in verts:
            v[33] = v[1]
    pack[:n_deg] = 0.0
    pack[:n_deg, 0:4] = torch.tensor([1.0, -0.0, -0.0, DEGENERATE_C0])
    pack[:n_deg, 16] = 3.0
    lo = np.min([v.min(0) for v in verts], 0)
    hi = np.max([v.max(0) for v in verts], 0)
    inner_lo = np.maximum(lo, -1000.0)
    inner_hi = np.minimum(hi, 1000.0)
    kind = np.arange(n_rays) % 6
    p = rs.uniform(inner_lo, inner_hi, (n_rays, 3))
    d = rs.normal(size=(n_rays, 3))
    target = rs.integers(n_deg, n_rows, n_rays) if n_rows > n_deg else None
    aim = kind == 0
    if target is not None:
        target = np.where(rs.random(n_rays) < 0.25, min(1, n_rows - 1),
                          target)
        cen = sum(v[target] for v in verts) / 3.0
        d[aim] = cen[aim] - p[aim]
    near_x = kind == 1
    d[near_x] = [1.0, 0.0, 0.0] + 0.2 * rs.normal(size=(near_x.sum(), 3))
    far = kind == 2
    p[far] = [lo[0] - 1000.0, hi[1] + 4000.0, 0.0]
    p[far, 2] = rs.uniform(lo[2], hi[2], far.sum())
    d[far] = [1.0, 0.0, 0.0]
    zero = kind == 3
    d[zero] = np.where(rs.random((zero.sum(), 1)) < 0.5, 0.0, -0.0)
    axis = kind == 5
    ax = rs.integers(0, 3, axis.sum())
    d[axis] = -0.0
    d[np.nonzero(axis)[0], ax] = np.where(rs.random(axis.sum()) < 0.5, 1.0,
                                          -1.0)
    with np.errstate(invalid="ignore"):
        norm = np.linalg.norm(d, axis=1, keepdims=True)
        d = np.where(norm > 0, d / np.where(norm > 0, norm, 1.0), d)
    r8 = np.zeros((8, n_rays), F32)
    r8[0:3], r8[3:6] = p.T, d.T
    return pack.contiguous(), r8
