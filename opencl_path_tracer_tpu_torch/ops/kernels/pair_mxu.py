"""K10: the pairs round of the pair intersector, and K11: the winners'
attribute fetch (CUDA kernels and plain versions).

Port of `opencl_path_tracer_tpu/ops/pallas/pair_mxu.py`: `DOP_SIGNS`
and `build_dops` (pair_mxu.py:51-85), `build_visits` (:88-121), the
visit kernel `_pair_visit_core` (built by `_mk_pair_visit_kernel`,
launched by `_run_pair_visits`, :141-370) in its thin form (`pair_visits`,
two streams) and its full form (`pair_visits_full`, thin=False: five
streams, the `pairmx` payload), the in-kernel features `_infeat_rows`
(:124-138, `infeat_rows`), the attribute fetch `_attr_fetch_kernel`
(launched by `fetch_attrs`, :373-472) and `pairs_round_mxu` (:475-547),
both branches, whose pair expansion and sort are `sort_pairs`.

A pairs round tests (ray, cluster) pairs. The pairs are sorted by
cluster key (stable: `torch.sort`), padded with dummy pairs (key C) to
whole tiles of `trp`, and each tile is tested against every cluster
whose run of keys touches it: a pair whose tile spans a run boundary is
tested against both clusters, as on the TPU, whose visit list
(`build_visits`) is the union of run starts and tile starts. Extra tests
only lower a pair's best t with real hits; `pend` depends on them.

Per visit (pair lane, cluster of cs triangles): the conservative bf16
Plucker edge tests with the per-lane eps of `build_march_scene`
(E_k >= -(col(17 + k) m + col(20 + k)) when vn > 0, E_k <= that bound
otherwise, m = max |P x D|), the exact float32 t with t > 0; the two
least (t, index) candidates; K1's exact test on each (the TPU fetches
the rows with a one-hot matmul over the exact bf16 3-split, the port
loads the float32 row of tric and adds +0.0). The first candidate that
passes is the visit's hit; when both fail and a second existed, a third
might win and the pair is PENDING. Visits merge by (t, g) lexicographic
minimum over found hits, g = cluster * cs + index (the cluster-ordered
triangle id), and pend by maximum; the order of visits does not matter.
Thin output per pair: t (BIG on a miss) and g * 2 + pend (g = 0 when
nothing was found), float32. Full output per pair: t, the winner's nx,
ny, nz (tric columns 0-2 + 0.0) and m * 2 + pend (m its column 16), the
attributes zero and m = 0 when nothing was found.

infeat: the TPU kernel computes the features itself (`_infeat_rows`),
where interpret mode contracts the cross products into fma(a, b, -(c
d)); `plucker_feat` rounds each product and the difference separately.
On 16,384 random rays every bit of the in-kernel features matched the
fused form, and 1.5 % of the low bf16 parts differed from the separate
one (`tests/test_torch_pair_options.py` holds the probe), so `infeat` is
a flag of both entries and of their plain versions: it selects the fused
features. Nothing else about a visit changes.

Rounding (XLA's CPU contraction in the interpret-mode kernel): E sums
its 18 exact bf16 products in two float32 accumulators, even and odd
terms, as K13a; the dot products of t and of the exact test are K1's
(`intersect_kernel._dot3`, the edge test fma(t, vm, pm)); the lane's
cross products are fma(a, b, -(c d)) and each eps term
fma(col, m, col).
"""

from __future__ import annotations

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    BIG, TRI_COLS, _dot3, _round_up,
)
from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
    plucker_feat, split_bf16_exact,
)

DOP_SIGNS = ((1.0, 1.0, 1.0), (1.0, -1.0, 1.0),
             (1.0, 1.0, -1.0), (1.0, -1.0, -1.0))
_PLAIN_VISITS = 8    # visits per batch of pair_visits_plain


def build_dops(rt, cs: int, c: int) -> torch.Tensor:
    """(C, 8) float32 [lo0..lo3 | hi0..hi3]: each cluster's support
    interval along the four diagonal axes of a 14-DOP, over the
    cluster-ordered triangles rt, inflated like the cluster boxes."""
    r1, r2, r3 = (getattr(rt, f).cpu().numpy() for f in ("r1", "r2", "r3"))
    pad = c * cs - r1.shape[0]
    out = np.zeros((c, 8), np.float32)
    for j, s in enumerate(DOP_SIGNS):
        u = np.asarray(s, np.float64)
        pv = np.stack([r1 @ u, r2 @ u, r3 @ u])
        plo, phi = pv.min(0), pv.max(0)
        if pad:
            plo = np.concatenate([plo, np.full(pad, np.inf)])
            phi = np.concatenate([phi, np.full(pad, -np.inf)])
        slo = plo.reshape(c, cs).min(1)
        shi = phi.reshape(c, cs).max(1)
        w = np.where(np.isfinite(shi - slo), shi - slo, 0.0)
        delta = 1e-4 * w + 1e-3
        out[:, j] = np.where(np.isfinite(slo), slo - delta, slo)
        out[:, 4 + j] = np.where(np.isfinite(shi), shi + delta, shi)
    return torch.as_tensor(out, device=rt.device)


def build_visits(keys_s: torch.Tensor, trp: int, c: int):
    """Cluster-sorted pair keys (Ppad,) in [0, c] (c = dummy) -> (vb, vc),
    (V,) int32 each, V = Ppad / trp + c + 1: tile ids, non-decreasing,
    and cluster ids (-1: no visit). One event per run start and one per
    tile start (the run covering the tile's first pair), ordered by
    position, then cluster."""
    dev = keys_s.device
    ppad = keys_s.shape[0]
    b = ppad // trp
    keys = keys_s.to(torch.int64)
    cids = torch.arange(c + 1, device=dev)
    starts = torch.searchsorted(keys, cids)
    starts_ext = torch.cat([starts, torch.tensor([ppad], device=dev)])
    cnt = starts_ext[1:] - starts_ext[:-1]
    pe_run = starts.clamp(max=ppad - 1)
    ce_run = torch.where((cnt > 0) & (cids < c), cids, -1)
    tp = torch.arange(b, device=dev) * trp
    cov = torch.searchsorted(starts, tp, right=True) - 1
    ce_tile = torch.where(cov < c, cov, -1)
    pe = torch.cat([pe_run, tp])
    ce = torch.cat([ce_run, ce_tile])
    order = torch.argsort(pe * (c + 2) + ce + 1)
    return ((pe[order] // trp).to(torch.int32),
            ce[order].to(torch.int32))


def infeat_rows(rays8: torch.Tensor) -> torch.Tensor:
    """`_infeat_rows`: plucker_feat's (32, R) bfloat16 rows [phi_hi(6),
    phi_lo(6), phi_hi(6), 0(14)] from (8, R) rays, with each cross product
    term fma(a, b, -(c d)), as interpret mode rounds it in the kernel."""
    px, py, pz, dx, dy, dz = (rays8[k] for k in range(6))
    phi = torch.stack([fp.fma(py, dz, -(pz * dy)), fp.fma(pz, dx, -(px * dz)),
                       fp.fma(px, dy, -(py * dx)), dx, dy, dz])
    hi, lo = split_bf16_exact(phi)
    zeros = torch.zeros((14, phi.shape[1]), dtype=torch.bfloat16,
                        device=phi.device)
    return torch.cat([hi, lo, hi, zeros])


def _visit(rays, feat, trig, tric, cid, cs: int):
    """One batch of visits: rays (8, B, trp) and features (18, B, trp)
    of each visit's tile, cluster ids cid (B,). Returns (found, t, g,
    pend), (B, trp) each."""
    dev = rays.device
    j = torch.arange(cs, device=dev)
    rows = cid[:, None] * cs + j                               # (B, cs)
    tc = tric[rows]                                            # (B, cs, 24)

    def col(k):
        return tc[:, :, k, None]                               # (B, cs, 1)

    p = (rays[0][:, None], rays[1][:, None], rays[2][:, None])  # (B, 1, trp)
    d = (rays[3][:, None], rays[4][:, None], rays[5][:, None])
    e = []
    for k in range(3):
        w = trig[(3 * cid[:, None] + k) * cs + j][:, :, :18].float()
        acc = [w[:, :, 0, None] * feat[0][:, None],
               w[:, :, 1, None] * feat[1][:, None]]
        for q in range(2, 18):
            acc[q % 2] = acc[q % 2] + w[:, :, q, None] * feat[q][:, None]
        e.append(acc[0] + acc[1])
    ml = torch.maximum(torch.maximum(
        fp.fma(p[1], d[2], -(p[2] * d[1])).abs(),
        fp.fma(p[2], d[0], -(p[0] * d[2])).abs()),
        fp.fma(p[0], d[1], -(p[1] * d[0])).abs())
    # A superset of the (triangle, lane) entries that pass the sign tests
    # in float32 alone (each eps widened by 2^-20, above the rounding of
    # the unfused eps); the exact tests and t run on those entries only.
    # A lane with D = 0 (the zero rays that pad a batch) has t = c0 / 0,
    # never below BIG, so it finds nothing and is left out.
    wide = [(col(17 + k) * ml + col(20 + k)) * (1.0 + 2.0 ** -20)
            for k in range(3)]
    maybe = (((e[0] >= -wide[0]) & (e[1] >= -wide[1]) & (e[2] >= -wide[2]))
             | ((e[0] <= wide[0]) & (e[1] <= wide[1]) & (e[2] <= wide[2])))
    maybe &= (d[0] != 0.0) | (d[1] != 0.0) | (d[2] != 0.0)
    bi, ji, li = maybe.nonzero(as_tuple=True)
    c = tc[bi, ji]                                             # (K, 24)
    pk = tuple(x[bi, 0, li] for x in p)
    dk = tuple(x[bi, 0, li] for x in d)
    mk = ml[bi, 0, li]
    ek = [x[bi, ji, li] for x in e]
    nrm = (c[:, 0], c[:, 1], c[:, 2])
    vn = _dot3(nrm, dk)
    t = (c[:, 3] - _dot3(nrm, pk)) / vn
    pos = vn > 0.0
    ep = [fp.fma(c[:, 17 + k], mk, c[:, 20 + k]) for k in range(3)]
    va = (ek[0] >= -ep[0]) & (ek[1] >= -ep[1]) & (ek[2] >= -ep[2])
    vb = (ek[0] <= ep[0]) & (ek[1] <= ep[1]) & (ek[2] <= ep[2])
    valid = ((pos & va) | (~pos & vb)) & (t > 0.0)
    tm = torch.full(e[0].shape, BIG, device=dev)
    tm[bi[valid], ji[valid], li[valid]] = t[valid]
    m1 = tm.amin(1)
    a1 = tm.argmin(1)                                      # first on ties
    tm2 = tm.scatter(1, a1[:, None], BIG)
    m2 = tm2.amin(1)
    a2 = tm2.argmin(1)

    def exact(a):
        c = tric[cid[:, None] * cs + a][..., :16] + 0.0        # (B, trp, 16)
        pl = tuple(x[:, 0] for x in p)                          # (B, trp)
        dl = tuple(x[:, 0] for x in d)

        def dots(b):
            v = (c[..., b], c[..., b + 1], c[..., b + 2])
            return _dot3(v, pl), _dot3(v, dl)

        pn, vn_ = dots(0)
        t_ = (c[..., 3] - pn) / vn_
        ok = t_ > 0.0
        for b in (4, 8, 12):
            pm, vm = dots(b)
            ok = ok & (fp.fma(t_, vm, pm) >= c[..., b + 3])
        return ok

    v1 = exact(a1) & (m1 < BIG)
    v2 = exact(a2) & (m2 < BIG)
    use2 = ~v1 & v2
    found = v1 | use2
    pend = ~v1 & ~v2 & (m2 < BIG)
    ct = torch.where(use2, m2, m1)
    cg = (cid[:, None] * cs + torch.where(use2, a2, a1)).to(torch.float32)
    return found, ct, cg, pend


def pair_visits_plain(keys_s: torch.Tensor, rays8p: torch.Tensor,
                      trig: torch.Tensor, tric: torch.Tensor, cs: int,
                      trp: int, c: int, infeat: bool = False):
    """Plain PyTorch version of K10 (thin): (t, g * 2 + pend), (Ppad,)
    float32 each, for the cluster-sorted pairs (keys_s (Ppad,) int32, rays
    (8, Ppad)). Visits run in batches of _PLAIN_VISITS; their hits merge
    per tile by (t, g) minimum, pend by maximum. infeat: the features of
    `infeat_rows`, else `plucker_feat`'s."""
    dev = rays8p.device
    ppad = rays8p.shape[1]
    nb = ppad // trp
    vb, vc = build_visits(keys_s, trp, c)
    keep = vc >= 0
    vb, vc = vb[keep].long(), vc[keep].long()
    rays_t = rays8p.reshape(8, nb, trp)
    feats = infeat_rows if infeat else plucker_feat
    feat = feats(rays8p)[:18].float().reshape(18, nb, trp)
    nv = vb.numel()
    t_v = torch.full((nv, trp), BIG, device=dev)
    g_v = torch.zeros((nv, trp), device=dev)
    p_v = torch.zeros((nv, trp), device=dev)
    for s in range(0, nv, _PLAIN_VISITS):
        e = s + _PLAIN_VISITS
        found, ct, cg, pend = _visit(rays_t[:, vb[s:e]], feat[:, vb[s:e]],
                                     trig, tric, vc[s:e], cs)
        t_v[s:e] = torch.where(found, ct, torch.full_like(ct, BIG))
        g_v[s:e] = torch.where(found, cg, torch.full_like(cg, -1.0))
        p_v[s:e] = pend.to(torch.float32)
    idx = vb[:, None].expand(-1, trp)
    t = torch.full((nb, trp), BIG, device=dev).scatter_reduce_(
        0, idx, t_v, "amin")
    # The least g among the visits that reach the tile's least t.
    none = float(1 << 30)
    at_min = (g_v >= 0.0) & (t_v == t[vb])
    g = torch.full((nb, trp), none, device=dev).scatter_reduce_(
        0, idx, torch.where(at_min, g_v, torch.full_like(g_v, none)), "amin")
    g = torch.where(g < none, g, torch.zeros_like(g))
    pend = torch.zeros((nb, trp), device=dev).scatter_reduce_(
        0, idx, p_v, "amax")
    return t.reshape(-1), (g * 2.0 + pend).reshape(-1)


def _check_scene_packs(trig, tric, cs, c):
    _build.check(tric, "tric", (None, TRI_COLS))
    _build.check(trig, "trig", (3 * tric.shape[0], 32), dtype=torch.bfloat16)
    if tric.shape[0] < c * cs or c * cs >= 1 << 22:
        raise ValueError(f"the packs hold {tric.shape[0]} triangles, fewer "
                         f"than {c} clusters of {cs} (or 2^22 or more)")


def _check_visits(keys_s, rays8p, trig, tric, cs, trp, c, what):
    _build.check(keys_s, "keys_s", (None,), dtype=torch.int32)
    ppad = keys_s.shape[0]
    _build.check(rays8p, "rays8p", (8, ppad))
    _check_scene_packs(trig, tric, cs, c)
    if not (keys_s.device == rays8p.device == trig.device == tric.device):
        raise ValueError("keys_s, rays8p, trig and tric must be on one "
                         "device")
    if ppad % trp or trp % 128 or not 0 < trp <= 1024 or cs % 64:
        raise ValueError(f"{what} needs Ppad a multiple of trp, trp a "
                         f"multiple of 128 up to 1024 and cs a multiple of "
                         f"64; got Ppad {ppad}, trp {trp}, cs {cs}")


def _launch_visits(entry, keys_s, rays8p, trig, tric, cs, trp, c, *extra,
                   n_out=2):
    ppad = keys_s.shape[0]
    outs = [torch.empty(ppad, dtype=torch.float32, device=rays8p.device)
            for _ in range(n_out)]
    if ppad:
        _build.launch(entry, keys_s, rays8p, trig, tric, *outs, ppad, trp,
                      cs, c, *extra)
    return tuple(outs)


def pair_visits(keys_s: torch.Tensor, rays8p: torch.Tensor,
                trig: torch.Tensor, tric: torch.Tensor, cs: int, trp: int,
                c: int, infeat: bool = False):
    """K10 (thin) on cluster-sorted pairs: (t, g * 2 + pend), (Ppad,)
    float32 each. keys_s: (Ppad,) int32 ascending in [0, c], Ppad a
    multiple of trp; rays8p: (8, Ppad). The features are computed in the
    kernel (fused cross products with infeat), whose edge values run on
    the tensor cores behind a certified margin (`csrc/pair_visit.cu`).
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _check_visits(keys_s, rays8p, trig, tric, cs, trp, c, "pair_visits")
    if rays8p.device.type == "cpu":
        return pair_visits_plain(keys_s, rays8p, trig, tric, cs, trp, c,
                                 infeat)
    return _launch_visits("pair_visit", keys_s, rays8p, trig, tric, cs, trp,
                          c, int(infeat))


def pair_visits_full_plain(keys_s: torch.Tensor, rays8p: torch.Tensor,
                           trig: torch.Tensor, tric: torch.Tensor, cs: int,
                           trp: int, c: int, infeat: bool = False):
    """Plain PyTorch version of K10's full form: (t, nx, ny, nz, m * 2 +
    pend), (Ppad,) float32 each: the thin version's winner with its tric
    row's columns 0, 1, 2 and 16 (+ 0.0), zeros where nothing was found
    (t = BIG)."""
    t, gp = pair_visits_plain(keys_s, rays8p, trig, tric, cs, trp, c, infeat)
    g = torch.floor(gp / 2.0)
    pend = gp - 2.0 * g
    nx, ny, nz, m = fetch_attrs_plain(
        torch.where(t < BIG, g, torch.full_like(g, -1.0)), tric)
    return t, nx, ny, nz, m * 2.0 + pend


def pair_visits_full(keys_s: torch.Tensor, rays8p: torch.Tensor,
                     trig: torch.Tensor, tric: torch.Tensor, cs: int,
                     trp: int, c: int, infeat: bool = False):
    """K10's full form (thin=False, the `pairmx` payload) on cluster-sorted
    pairs: (t, nx, ny, nz, m * 2 + pend), (Ppad,) float32 each, the same
    visits as `pair_visits` with the winner's attributes read from tric in
    the kernel. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    _check_visits(keys_s, rays8p, trig, tric, cs, trp, c, "pair_visits_full")
    if rays8p.device.type == "cpu":
        return pair_visits_full_plain(keys_s, rays8p, trig, tric, cs, trp, c,
                                      infeat)
    return _launch_visits("pair_visit_full", keys_s, rays8p, trig, tric, cs,
                          trp, c, int(infeat), n_out=5)


def pair_visits_simt(keys_s: torch.Tensor, rays8p: torch.Tensor,
                     trig: torch.Tensor, tric: torch.Tensor, cs: int,
                     trp: int, c: int):
    """K10's first kernel (`csrc/pair_visit.cu::pair_simt_kernel`: every
    product on the float32 cores, one pair per thread), on CUDA tensors:
    pair_visits' (t, g * 2 + pend). For the checks only (the smoke and the
    cuda tests hold the new kernel against it on whole launches and time
    the two in turns); no render path calls it."""
    _check_visits(keys_s, rays8p, trig, tric, cs, trp, c, "pair_visits_simt")
    if rays8p.device.type != "cuda":
        raise ValueError("pair_visits_simt runs on CUDA tensors only")
    return _launch_visits("pair_visit_simt", keys_s, rays8p, trig, tric, cs,
                          trp, c)


def pair_visits_counted(keys_s: torch.Tensor, rays8p: torch.Tensor,
                        trig: torch.Tensor, tric: torch.Tensor, cs: int,
                        trp: int, c: int):
    """pair_visits' kernel on CUDA tensors, also counting the edge tests
    its margin sent to the float32 chain: ((t, g * 2 + pend), the count as
    an int). For the checks only; no render path calls it."""
    _check_visits(keys_s, rays8p, trig, tric, cs, trp, c,
                  "pair_visits_counted")
    if rays8p.device.type != "cuda":
        raise ValueError("pair_visits_counted runs on CUDA tensors only")
    count = torch.zeros(1, dtype=torch.int64, device=rays8p.device)
    out = _launch_visits("pair_visit_count", keys_s, rays8p, trig, tric, cs,
                         trp, c, count)
    return out, int(count.item())


def fetch_attrs_plain(g: torch.Tensor, tric: torch.Tensor):
    """Plain PyTorch version of K11: (nx, ny, nz, m), (R,) float32 each,
    columns 0, 1, 2 and 16 of tric's row g (+ 0.0, the one-hot fetch's
    sign of zero), zeros where g < 0."""
    gi = g.to(torch.int64)
    ok = gi >= 0
    rows = tric[gi.clamp(min=0)]
    z = torch.zeros_like(g, dtype=torch.float32)
    return tuple(torch.where(ok, rows[:, k] + 0.0, z) for k in (0, 1, 2, 16))


def fetch_attrs(g: torch.Tensor, tric: torch.Tensor):
    """K11: (nx, ny, nz, m) of each ray's winning cluster-ordered triangle
    g ((R,) float32, negative = none: zeros). On the TPU a cluster sort, a
    visit-list one-hot matmul and a sort back; here one gather thread per
    ray (the same bits). CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    _build.check(g, "g", (None,))
    _build.check(tric, "tric", (None, TRI_COLS))
    if g.device != tric.device:
        raise ValueError("g and tric must be on one device")
    if g.device.type == "cpu":
        return fetch_attrs_plain(g, tric)
    r = g.shape[0]
    outs = [torch.empty(r, dtype=torch.float32, device=g.device)
            for _ in range(4)]
    if r:
        _build.launch("attr_fetch", g, tric, *outs, r, tric.shape[0])
    return tuple(outs)


def sort_pairs(comps, ids: torch.Tensor, c: int, trp: int):
    """Expand (L, R) rank-major candidate ids (row j = every ray's rank-j
    cluster, c = none) to pairs p = j R + i, padded with dummy pairs (key
    c, zero rays) to a multiple of trp and sorted by key, stably. Returns
    (keys_s (Ppad,) int32, rays8p (8, Ppad), order (Ppad,) int64: sorted
    position -> pair)."""
    l, r = ids.shape
    p = r * l
    ppad = _round_up(p, trp)
    dev = ids.device
    keys = torch.cat([ids.reshape(-1).to(torch.int32),
                      torch.full((ppad - p,), c, dtype=torch.int32,
                                 device=dev)])
    keys_s, order = torch.sort(keys, stable=True)
    ray = torch.where(order < p, order % r, torch.full_like(order, r))
    z = torch.zeros(r + 1, dtype=torch.float32, device=dev)
    rows = [torch.cat([x, z[:1]]) for x in comps] + [z, z]
    rays8p = torch.stack(rows)[:, ray].contiguous()
    return keys_s, rays8p, order


def pairs_round_mxu(comps, ids: torch.Tensor, scene, c: int, cs: int,
                    trp: int, thin: bool = True, infeat: bool = False):
    """One pairs round: comps, six (R,) ray components; ids, (L, R)
    rank-major candidate clusters. Returns ((t, g), pend) when thin: each
    ray's least t over its L pairs (the first rank on ties), the winning
    pair's g as float32 (junk on a miss), and whether any of its pairs
    ended pending; ((t, nx, ny, nz, m), pend) otherwise, the winning
    pair's attributes (K10's full form). infeat: K10 computes the fused
    features (see the module docstring)."""
    l, r = ids.shape
    keys_s, rays8p, order = sort_pairs(comps, ids, c, trp)
    visits = pair_visits if thin else pair_visits_full
    outs = visits(keys_s, rays8p, scene.trig, scene.tric, cs, trp, c, infeat)
    # Back to pair order (the TPU's slot-keyed back sort), rank-major.
    back = [torch.empty_like(o).index_copy_(0, order, o)[:r * l].reshape(l, r)
            for o in outs]
    t_lr, mp_lr = back[0], back[-1]
    best = t_lr.amin(0)
    which = t_lr.argmin(0)                                 # first on ties
    pend = (mp_lr - 2.0 * torch.floor(mp_lr / 2.0)).amax(0) > 0.0

    def pick(a):
        """The winning rank's value as the TPU's one-hot sum over the L
        ranks gives it: XLA's sum starts from +0.0, so a winning -0.0
        becomes +0.0 for L >= 2 (a size-1 sum is a reshape)."""
        v = a.gather(0, which[None])[0]
        return v + 0.0 if l > 1 else v

    if thin:
        return (best, torch.floor(pick(mp_lr) / 2.0)), pend
    return (best, pick(back[1]), pick(back[2]), pick(back[3]),
            torch.floor(pick(mp_lr) / 2.0)), pend
