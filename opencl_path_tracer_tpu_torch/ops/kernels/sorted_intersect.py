"""K9: the per-ray cluster candidates, and the pair-expansion intersector
for large scenes (`accel='pairwin'`) that runs K9, K10 and K11.

Port of `opencl_path_tracer_tpu/ops/pallas/sorted_intersect.py`: `BIG`
and `_hits_from_raw` (:98-118); `_cand_kernel` (launched by
`_run_candidates`, :419-523); `_auto_cluster_size`, `split_by_size`,
`_merge_best` and `PAIR_TPU_WINNER` (:526-662); and
`make_pair_intersect` (:665-1653) in the production configuration,
`PAIR_TPU_WINNER`: the MXU pairs round (K10), DOP boxes, the thin
(t, triangle id) payload, the sort schedule, with or without ids. The
other configurations (the VPU pairs round K12 with mxu=False, move
'gather' or 'chain', infeat, approx) raise NotImplementedError
(ROADMAP.md queue 2).

The schedule is the JAX package's, lane for lane: the scene-spanning
triangles seed every ray's best t (K4, or K1 + K2 with ids); round 1
tests every ray against its l1 nearest passing clusters (K9, then K10)
and certifies a ray when its best t is at most the entry distance of
its first untested candidate and no pair of it ended pending; the
escalations take the first u unresolved rays in slot order (the
JAX package's (flag, slot) sort) and test each one's next w ranks; a
dense tail (K4, or K1 with ids) certifies the rest `tail` rays at a
time; K11 fetches the winners' attributes once at the end. Capacities,
windows and selection depths are identical, so `resolved`, `done` and
`pend` follow the TPU's. The TPU moved data by sorting because its
gathers are slow; the port gathers and scatters (`argsort`,
`index_select`, indexed assignment) where the JAX package sorts data
along, and sorts only where a sort decides which work is done.
"""

from __future__ import annotations

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.types import Hits, Rays
from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    BIG, _round_up, build_tri_pack, make_pallas_intersect, minarg, pack_rays,
)
from opencl_path_tracer_tpu_torch.ops.kernels.march_kernel import (
    build_march_scene,
)
from opencl_path_tracer_tpu_torch.ops.kernels import pair_mxu
from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
    make_minarg_intersect,
)

MAX_RANKS = 48   # the deepest K9 selection csrc/pair_cand.cu keeps (l <= 48)
_PLAIN_RAYS = 8192   # rays per chunk of candidates_plain

# Set to a list to make every pair-intersector call append a dict of its
# schedule's counts (rays, round 1's resolved rays, each escalation's
# (capacity, window, unresolved rays taken), the tail's rays and
# iterations, pending rays); None (the default) records nothing.
STATS = None

# The TPU's production configuration for large scenes (the JAX package's
# round-3 on-device sweeps; its numbers are the TPU's, not the port's).
# `make_pair_intersect`'s defaults are these values.
PAIR_TPU_WINNER = dict(mxu=True, dop=True, cluster_size=256, trp=1024,
                       l1=2, l2=6, thin=True, move="sort")
# The schedule's other constants, the JAX package's defaults: the deepest
# rank tested (l3), the candidate kernel's ray tile (trb, which sets the
# padding unit), and the capacity fractions of the escalations.
L3, TRB, U2_FRAC, U3_FRAC = 48, 512, 2, 32


def _hits_from_raw(rays: Rays, best_t, n3, m, r: int) -> Hits:
    """Hits from per-ray (t (BIG on a miss), normal, material) rows; a
    miss has t = -1 and zero p, n and mati."""
    best_t = best_t[:r]
    any_hit = best_t < BIG
    z = torch.zeros_like(best_t)
    safe_t = torch.where(any_hit, best_t, z)
    return Hits(
        t=torch.where(any_hit, best_t, torch.full_like(best_t, -1.0)),
        p=tuple(torch.where(any_hit, rays.p[k] + rays.d[k] * safe_t, z)
                for k in range(3)),
        n=tuple(torch.where(any_hit, a[:r], z) for a in n3),
        mati=torch.where(any_hit, m[:r], z).to(torch.int32),
    )


def _xmax(a, b):
    """XLA's maximum: NaN wins; +0.0 is above -0.0."""
    r = torch.where(a > b, a, torch.where(b > a, b, torch.where(
        torch.signbit(a), b, a)))
    return torch.where(torch.isnan(a) | torch.isnan(b),
                       torch.full_like(r, float("nan")), r)


def _xmin(a, b):
    """XLA's minimum: NaN wins; -0.0 is below +0.0."""
    r = torch.where(a < b, a, torch.where(b < a, b, torch.where(
        torch.signbit(a), a, b)))
    return torch.where(torch.isnan(a) | torch.isnan(b),
                       torch.full_like(r, float("nan")), r)


def _slab_axis(tmin, tmax, bl, bh, p, d):
    """One slab of the cluster test (d == 0: containment), as K9."""
    d0 = d == 0.0
    inv = torch.ones_like(d) / torch.where(d0, torch.ones_like(d), d)
    t1 = (bl - p) * inv
    t2 = (bh - p) * inv
    lo = _xmin(t1, t2)
    hi = _xmax(t1, t2)
    inside = (p >= bl) & (p <= bh)
    big = torch.full_like(lo, BIG)
    lo = torch.where(d0, torch.where(inside, -big, big), lo)
    hi = torch.where(d0, torch.where(inside, big, -big), hi)
    return _xmax(tmin, lo), _xmin(tmax, hi)


def candidates_plain(rays8t: torch.Tensor, boxes_r: torch.Tensor, l: int,
                     c: int):
    """Plain PyTorch version of K9: (ids (l, R) int32, ent (l, R) float32,
    nxt (R,) float32). Each ray's slab test against every cluster box
    (AABB, and with a (Cp, 16) table the 4 DOP axes), entry = max(tmin,
    0) where it passes; the l + 1 least (entry, cluster) in order: ids of
    the first l (c where none), their entries (BIG where none) and the
    entry of rank l, the certificate bound."""
    cp, boxw = boxes_r.shape
    r = rays8t.shape[1]
    dev = rays8t.device
    subc = torch.arange(cp, device=dev)[:, None]
    ids = torch.empty((l, r), dtype=torch.int32, device=dev)
    ent = torch.empty((l + 1, r), dtype=torch.float32, device=dev)
    box = [boxes_r[:, k:k + 1] for k in range(boxw)]
    for s in range(0, r, _PLAIN_RAYS):
        x = rays8t[:, s:s + _PLAIN_RAYS]
        tmin = torch.full((cp, x.shape[1]), -BIG, device=dev)
        tmax = torch.full((cp, x.shape[1]), BIG, device=dev)
        for ax in range(3):
            tmin, tmax = _slab_axis(tmin, tmax, box[ax], box[ax + 3],
                                    x[ax:ax + 1], x[3 + ax:4 + ax])
        if boxw == 16:
            for j, (_, sy, sz) in enumerate(pair_mxu.DOP_SIGNS):
                pu = (x[0:1] + sy * x[1:2]) + sz * x[2:3]
                du = (x[3:4] + sy * x[4:5]) + sz * x[5:6]
                tmin, tmax = _slab_axis(tmin, tmax, box[8 + j],
                                        box[12 + j], pu, du)
        ok = (tmax >= tmin) & (tmax >= 0.0) & (subc < c)
        entry = torch.where(ok, _xmax(tmin, torch.zeros_like(tmin)),
                            torch.full_like(tmin, BIG))
        m, idx = torch.sort(entry, dim=0, stable=True)
        m = m[:l + 1].clamp(max=BIG)
        ids[:, s:s + _PLAIN_RAYS] = torch.where(
            m[:l] < BIG, idx[:l], torch.full_like(idx[:l], c)).to(torch.int32)
        ent[:, s:s + _PLAIN_RAYS] = m
    return ids, ent[:l], ent[l]


def run_candidates(rays8t: torch.Tensor, boxes_r: torch.Tensor, l: int,
                   c: int):
    """K9: (ids (l, R) int32, ent (l, R), nxt (R,)) for the (8, R) rays
    against the (Cp, 8) or (Cp, 16) cluster table, Cp >= c (rows past c
    are padding). CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    _build.check(rays8t, "rays8t", (8, None))
    cp, boxw = boxes_r.shape
    _build.check(boxes_r, "boxes_r", (cp, boxw))
    if boxw not in (8, 16) or not 0 < c <= cp or not 0 < l <= MAX_RANKS:
        raise ValueError(f"run_candidates needs an (Cp, 8|16) table with "
                         f"0 < c <= Cp and 0 < l <= {MAX_RANKS}; got "
                         f"{tuple(boxes_r.shape)}, c {c}, l {l}")
    if rays8t.device != boxes_r.device:
        raise ValueError("rays8t and boxes_r must be on one device")
    if rays8t.device.type == "cpu":
        return candidates_plain(rays8t, boxes_r, l, c)
    r = rays8t.shape[1]
    ids = torch.empty((l, r), dtype=torch.int32, device=rays8t.device)
    ent = torch.empty((l + 1, r), dtype=torch.float32, device=rays8t.device)
    if r:
        _build.launch("pair_cand", rays8t, boxes_r, ids, ent, r, cp, boxw, c,
                      l)
    return ids, ent[:l], ent[l]


def _auto_cluster_size(n_tris: int, cluster_size: int) -> int:
    """Doubles the cluster size until the padded cluster count times 128
    fits the TPU candidates kernel's scoped-VMEM budget (480,000); kept
    as the JAX package's rule, so the clusters are the same."""
    while _round_up(-(-n_tris // cluster_size), 128) * 128 > 480_000:
        cluster_size *= 2
    return cluster_size


def split_by_size(tris: TrianglesSoA, with_indices: bool = False):
    """Partition the triangles into (big, rest) by bounding-box diagonal:
    big when above min(0.25 x the scene's diagonal, 50 x the median
    diagonal), at most 64 of them (largest first). The big ones (walls,
    ground planes) are tested densely and seed every ray's best t; the
    rest form the clusters. Returns (big | None, rest | None) and with
    with_indices=True also each part's row indices."""
    r1, r2, r3 = (getattr(tris, f).cpu().numpy() for f in ("r1", "r2", "r3"))
    lo = np.minimum(np.minimum(r1, r2), r3)
    hi = np.maximum(np.maximum(r1, r2), r3)
    diag = np.linalg.norm(hi - lo, axis=1)
    scene_diag = np.linalg.norm(hi.max(0) - lo.min(0))
    big = diag > min(0.25 * scene_diag, 50.0 * float(np.median(diag)))
    if int(big.sum()) > 64:
        big = diag > np.sort(diag)[-65]
    idx = np.arange(len(diag), dtype=np.int32)
    parts = tuple(tris.take(idx[mask]) if mask.any() else None
                  for mask in (big, ~big))
    if with_indices:
        return parts + (idx[big], idx[~big])
    return parts


def _merge_best(cur, new):
    """Elementwise min-merge of two (t, ...) tuples, strict <."""
    better = new[0] < cur[0]
    return tuple(torch.where(better, n, c) for n, c in zip(new, cur))


def make_pair_intersect(tris: TrianglesSoA, *, cluster_size: int = 256,
                        l1: int = 2, l2: int = 6, trp: int = 1024,
                        tail: int = 8192, mxu: bool = True, dop: bool = True,
                        move: str = "sort", infeat: bool = False,
                        thin: bool = True, with_ids: bool = False,
                        approx: bool = False):
    """The pair-expansion intersector (see the module docstring):
    intersect(rays) -> Hits, or (Hits, ids) with with_ids=True (ids: the
    winner's index in `tris`, -1 on a miss). The defaults are
    `PAIR_TPU_WINNER`; its flags (mxu, dop, move, thin, and infeat and
    approx off) are the only ones ported. See `STATS` for the schedule's
    counts."""
    if not (mxu and dop and thin and move == "sort") or infeat or approx:
        raise NotImplementedError(
            "make_pair_intersect is ported in its production configuration "
            "only (mxu=True, dop=True, thin=True, move='sort', no infeat or "
            "approx); the VPU pairs round (K12, mxu=False) and the other "
            "modes are in ROADMAP.md queue 2")
    if not (0 < l1 <= MAX_RANKS and 0 < l2 <= MAX_RANKS):
        raise ValueError(f"l1 and l2 must be in 1..{MAX_RANKS}")
    big, rest, big_idx, rest_idx = split_by_size(tris, with_indices=True)
    if rest is None:
        if with_ids:
            return make_minarg_intersect(tris, with_ids=True)
        return make_pallas_intersect(tris)
    dev = tris.device
    cs = _auto_cluster_size(rest.count, cluster_size)
    if with_ids:
        big_isect = (make_minarg_intersect(big, with_ids=True)
                     if big is not None else None)
        big_map = (torch.as_tensor(big_idx, dtype=torch.int32, device=dev)
                   if big is not None else None)
        mscene, rt, c, march_order = build_march_scene(rest, cs,
                                                       with_order=True)
        gmap = np.full((c * cs,), -1, np.int32)
        gmap[:len(march_order)] = rest_idx[march_order]
        g_to_orig = torch.as_tensor(gmap, device=dev)
    else:
        big_isect = (make_pallas_intersect(big) if big is not None else None)
        mscene, rt, c = build_march_scene(rest, cs)
    cp = _round_up(c, 128)
    boxes_r = torch.zeros((cp, 16), device=dev)
    boxes_r[:c] = torch.cat([mscene.boxes_lo, mscene.boxes_hi,
                             torch.zeros((c, 2), device=dev),
                             pair_mxu.build_dops(rt, cs, c)], dim=1)
    # The TPU kernel's VMEM rule; it sets rpad through `unit`.
    trb = TRB
    while cp * trb > 480_000 and trb > 128:
        trb //= 2
    l1, l2, maxrank = min(l1, c), min(l2, c), min(L3, c)
    if with_ids:
        tail_pack = build_tri_pack(tris)
        n_cols = tuple(tris.n[:, k].contiguous() for k in range(3))
        mati_col = tris.mati.to(torch.float32)
        tail_isect = None
    else:
        tail_isect = make_pallas_intersect(tris)

    def run_pairs(comps, ids):
        return pair_mxu.pairs_round_mxu(comps, ids, mscene, c, cs, trp)

    def intersect(rays: Rays):
        r = rays.count
        unit = max(trp, trb)
        rpad = _round_up(r, unit)
        stats = {"rays": r} if STATS is not None else None
        comps = [torch.cat([x, x.new_zeros(rpad - r)])
                 for x in (*rays.p, *rays.d)]
        zeros = torch.zeros(rpad, device=comps[0].device)
        seed_ids = (torch.full((rpad,), -1, dtype=torch.int32,
                               device=zeros.device) if with_ids else None)
        if big_isect is not None:
            hb = big_isect(Rays(p=tuple(comps[:3]), d=tuple(comps[3:])))
            if with_ids:
                hb, bi = hb
                seed_ids = torch.where(hb.valid, big_map[bi.clamp(min=0)],
                                       seed_ids)
            best_t = torch.where(hb.valid, hb.t, torch.full_like(hb.t, BIG))
            overlay = [hb.n[0].clone(), hb.n[1].clone(), hb.n[2].clone(),
                       hb.mati.to(torch.float32)]
        else:
            best_t = torch.full((rpad,), BIG, device=zeros.device)
            overlay = [zeros.clone() for _ in range(4)]
        best_g = torch.full((rpad,), -1.0, device=zeros.device)

        # Round 1: every ray against its l1 nearest passing clusters.
        ids1, _, nxt1 = run_candidates(pack_rays(comps[:3], comps[3:]),
                                       boxes_r, l1, c)
        (t_new, g_new), pend = run_pairs(comps, ids1)
        best_t, best_g = _merge_best((best_t, best_g), (t_new, g_new))
        resolved = ((best_t <= nxt1) | (nxt1 >= BIG)) & ~pend
        done = torch.full((rpad,), l1, dtype=torch.int64, device=zeros.device)
        if stats is not None:
            stats["round1_resolved"] = int(resolved[:r].sum())
            stats["escalations"] = []

        def first_unresolved(u):
            """The first u rays in (resolved, slot) order."""
            return torch.argsort(resolved.to(torch.int32), stable=True)[:u]

        def escalation(u, w, sel):
            """Test the next w untested ranks of the first u unresolved
            rays (selection depth sel) and merge (`escalation_sort`)."""
            idx = first_unresolved(u)
            if stats is not None:
                stats["escalations"].append(
                    (u, w, int((~resolved[idx]).sum())))
            sub = [x[idx] for x in comps]
            d0 = done[idx]
            ids_all, ents_all, nxt = run_candidates(
                pack_rays(sub[:3], sub[3:]), boxes_r, sel, c)
            rows = d0[None, :] + torch.arange(w, device=d0.device)[:, None]
            ids = torch.where(rows < sel,
                              ids_all.gather(0, rows.clamp(0, sel - 1)),
                              torch.full_like(ids_all[:1], c))
            (t_new, g_new), pend_sub = run_pairs(sub, ids)
            d1 = torch.clamp(d0 + w, max=sel)
            bound = torch.where(
                d1 < sel, ents_all.gather(0, d1.clamp(0, sel - 1)[None])[0],
                nxt)
            t_cur = best_t[idx]
            better = t_new < t_cur
            t_m = torch.where(better, t_new, t_cur)
            best_t[idx] = t_m
            best_g[idx] = torch.where(better, g_new, best_g[idx])
            p_m = pend[idx] | pend_sub
            pend[idx] = p_m
            done[idx] = torch.maximum(d0, d1)
            resolved[idx] = resolved[idx] | (
                ((t_m <= bound) | (bound >= BIG)) & ~p_m)

        u2 = max(unit, (rpad // U2_FRAC // unit) * unit)
        if l2 > l1:
            escalation(u2, l2 - l1, min(maxrank, l2))
        if maxrank > l2:
            w3 = maxrank - l2
            escalation(max(unit, (rpad // U2_FRAC // 4 // unit) * unit), 8,
                       min(maxrank, l2 + 8))
            escalation(max(unit, (rpad // U2_FRAC // 16 // unit) * unit), w3,
                       maxrank)
            u3 = max(unit, (rpad // U3_FRAC // unit) * unit)
            it = 0
            while it < 4 and bool((~resolved & (done < maxrank)).any()):
                escalation(u3, w3, maxrank)
                it += 1

        # The dense tail, `tail` rays at a time, until every ray is
        # resolved.
        u4 = min(tail, rpad)
        n_tail = 0
        if stats is not None:
            stats["tail_rays"] = int((~resolved).sum())
            stats["pending"] = int(pend[:r].sum())
        while not bool(resolved.all()):
            idx = first_unresolved(u4)
            sub = Rays(p=tuple(x[idx] for x in comps[:3]),
                       d=tuple(x[idx] for x in comps[3:]))
            if with_ids:
                t1, g1 = minarg(pack_rays(sub.p, sub.d), tail_pack)
                hit = t1 < BIG
                g1 = g1.to(torch.int64)
                safe = g1.clamp(0, tris.count - 1)
                new_t = t1
                attrs = (n_cols[0][safe], n_cols[1][safe], n_cols[2][safe],
                         torch.where(hit, mati_col[safe],
                                     torch.zeros_like(t1)))
            else:
                ht = tail_isect(sub)
                new_t = torch.where(ht.valid, ht.t, torch.full_like(ht.t, BIG))
                attrs = (*ht.n, ht.mati.to(torch.float32))
            t_cur = best_t[idx]
            better = new_t < t_cur
            best_t[idx] = torch.where(better, new_t, t_cur)
            best_g[idx] = torch.where(better, torch.full_like(t_cur, -1.0),
                                      best_g[idx])
            for o, a in zip(overlay, attrs):
                o[idx] = torch.where(better, a, o[idx])
            if with_ids:
                seed_ids[idx] = torch.where(
                    better, torch.where(hit, g1, -1).to(torch.int32),
                    seed_ids[idx])
            resolved[idx] = True
            n_tail += 1
        if stats is not None:
            stats["tail_iterations"] = n_tail
            STATS.append(stats)

        fn = pair_mxu.fetch_attrs(best_g, mscene.tric)
        use = best_g >= 0.0
        n3 = tuple(torch.where(use, f, o) for f, o in zip(fn[:3], overlay))
        m = torch.where(use, fn[3], overlay[3])
        hits = _hits_from_raw(rays, best_t, n3, m, r)
        if not with_ids:
            return hits
        g_int = best_g.to(torch.int64).clamp(0, g_to_orig.shape[0] - 1)
        ids = torch.where(use, g_to_orig[g_int], seed_ids)
        ids = torch.where(best_t < BIG, ids, -1)
        return hits, ids[:r]

    return intersect
