"""K17: the two-level cluster intersector (`accel='cluster'`), the
Morton cluster packs and cluster-block test that K12 and K16 share, and
the skip rule's table (`sub_boxes`) that K12, K17 and K7 share.

Port of `opencl_path_tracer_tpu/ops/pallas/cluster_kernel.py`: `BIG`,
`ClusterScene` and `build_clusters` (cluster_kernel.py:58-139), the
per-tile culling `_interval_slab` and `_tile_cluster_lists` (:143-239),
the kernel `_kernel` (launched by `_run`, :245-388), `pack_rays_rows`
and `make_cluster_intersect` (:391-435).

`build_clusters` runs on the host in numpy and gives the JAX package's
packs bit for bit: triangles in stable Morton order of their centroids
(with `split_large`, the scene-spanning ones first), cut into C clusters
of K. A cluster's pack rows are the triangle pack's rows (`build_tri_pack`:
[n c0 m1 d1 m2 d2 m3 d3 mati 0*7]); the JAX package holds them as
(C, 24, K), fields on sublanes, and so does `ClusterScene.tri_pack`. The
kernels read the same numbers as (C K, 24) rows (`ClusterScene.rows`),
one triangle per row.

The cluster-block test (`cluster_nearest` here; `csrc/cluster_block.cuh`
on the card) is K1's exact test (`intersect_kernel.exact_test`: the
interpret-mode kernels of all three cluster intersectors round their
dots and edge tests as K1's does, which a probe of `_run_pairs` checked
against separately rounded products). Per ray, over a cluster's K
triangles: the least accepted t and the first triangle reaching it;
across clusters a strict `<`. The winner's normal and material are its
row's columns 0-2 and 16 plus +0.0 (the TPU's one-hot sum turns -0.0
into +0.0); a ray that hits nothing keeps (BIG, 0, 0, 0, 0).

K17 (`run_cluster`): one tile of `tr` rays walks its entry-sorted list
of the clusters its interval slab test passes (`_tile_cluster_lists`),
in list order; with `early_exit` it stops at the first entry that is
not below the tile's largest best t. On the card one CUDA block is one
tile (`csrc/cluster.cu`); the tile, not the block size, is what the
result depends on. There each ray also skips the sub-blocks of `SUB`
rows whose boxes (`cluster_sub_boxes`, built once per scene) its
segment to its running best misses, which the skip rule proves hold no
accepted t at or below that best: the same bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.accel.lbvh import morton3
from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.types import Hits, Rays
from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    BIG, SUB, TRI_COLS, build_tri_pack, exact_test,
)

_PLAIN_CELLS = 1 << 22    # (ray, triangle) tests per chunk of a plain version
MAX_TILE = 1024   # rays per tile K17 takes on the card (one CUDA block)
# K17's warp tests a sub-block for at most this many of its rays together,
# all 32 lanes on one ray's rows (csrc/cluster.cu); for more, each lane
# tests its own ray. 16 measured 1 % faster than 12 and 4-13 % faster
# than 8 and 4 on the stress camera and first-bounce rays, 24 the same
# (runtime/cull_ab.py --coop; PERF.md).
CLUSTER_COOP = 16


@dataclasses.dataclass(frozen=True)
class ClusterScene:
    """Morton clusters of triangles (see the module docstring)."""

    boxes: torch.Tensor      # (C, 8) float32 [lo3 hi3 0 0]
    tri_pack: torch.Tensor   # (C, 24, K) float32, the JAX package's layout

    def rows(self) -> torch.Tensor:
        """The packs as (C K, 24) float32 rows, one triangle per row."""
        c, cols, k = self.tri_pack.shape
        return self.tri_pack.transpose(1, 2).reshape(c * k, cols).contiguous()


def _norm3(v: np.ndarray) -> np.ndarray:
    """Euclidean norm over the last axis of (..., 3) float32, rounded as
    the jitted `jnp.linalg.norm`: sqrt(fma(z, z, fma(y, y, x x)))."""
    t = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    x, y, z = t.unbind(-1)
    return fp.sqrt(fp.fma(z, z, fp.fma(y, y, x * x))).numpy()


def build_clusters(tris: TrianglesSoA, cluster_size: int = 128,
                   split_large: bool = False):
    """(scene, C, K): the triangles in stable Morton order of their
    centroids, cut into C = ceil(T / K) clusters of K = cluster_size,
    the last padded with zero rows (never hit). With split_large, the
    triangles whose box diagonal exceeds a quarter of the scene's sort
    first, so they fill the leading clusters. Boxes: each cluster's
    triangle bounds (padding rows excluded). The packs live on the
    triangles' device."""
    t_count = tris.count
    k = cluster_size
    c = max(1, -(-t_count // k))
    total = c * k
    r1, r2, r3 = (getattr(tris, f).cpu().numpy() for f in ("r1", "r2", "r3"))
    lo = np.minimum(np.minimum(r1, r2), r3)
    hi = np.maximum(np.maximum(r1, r2), r3)
    mid = (r1 + r2 + r3) / np.float32(3.0)
    scene_lo = lo.min(0)
    extent = np.maximum(hi.max(0) - scene_lo, np.float32(1e-9))
    codes = morton3((mid - scene_lo) / extent)
    if split_large:
        diag = _norm3(hi - lo)
        scene_diag = _norm3(hi.max(0) - lo.min(0))
        codes = np.where(diag > np.float32(0.25) * scene_diag,
                         np.uint32(0), codes | np.uint32(1 << 30))
    codes = np.concatenate(
        [codes.astype(np.uint32),
         np.full(total - t_count, 0xFFFFFFFF, np.uint32)])
    order = np.argsort(codes, kind="stable")
    pad = order >= t_count
    safe = np.where(pad, 0, order)
    pack = build_tri_pack(tris).cpu().numpy()[safe]
    pack[pad] = 0.0
    lo_r = np.where(pad[:, None], np.float32(BIG), lo[safe])
    hi_r = np.where(pad[:, None], np.float32(-BIG), hi[safe])
    boxes = np.concatenate([lo_r.reshape(c, k, 3).min(1),
                            hi_r.reshape(c, k, 3).max(1),
                            np.zeros((c, 2), np.float32)], axis=1)
    dev = tris.device
    scene = ClusterScene(
        boxes=torch.as_tensor(boxes.astype(np.float32), device=dev),
        tri_pack=torch.as_tensor(
            np.ascontiguousarray(pack.reshape(c, k, TRI_COLS)
                                 .transpose(0, 2, 1)), device=dev))
    return scene, c, k


def pack_rays_rows(p, d, pad_to: int) -> torch.Tensor:
    """(Rpad, 8) float32 rows [px py pz dx dy dz 0 0], zero rows past R."""
    r = p[0].shape[0]
    buf = torch.zeros((pad_to, 8), dtype=torch.float32, device=p[0].device)
    for j in range(3):
        buf[:r, j] = p[j]
        buf[:r, 3 + j] = d[j]
    return buf


def cluster_nearest(rows: torch.Tensor, rays8: torch.Tensor):
    """The cluster-block test of the (..., 8, R) rays against the
    (..., K, 24) rows of one cluster each: (tmin, local int64), (..., R)
    each, the least accepted t (BIG where none) and the first row
    reaching it (0 where none)."""
    t, valid = exact_test(rows, rays8)
    tm = torch.where(valid, t, torch.full_like(t, BIG))
    return torch.min(tm, dim=-2)                 # first index on ties


def winner_attrs(rows: torch.Tensor, g: torch.Tensor, hit: torch.Tensor):
    """(nx, ny, nz, m) of the winning rows g, +0.0, and 0 where not hit."""
    w = rows[g]
    z = torch.zeros_like(w[:, 0])
    return tuple(torch.where(hit, w[:, j] + 0.0, z) for j in (0, 1, 2, 16))


# -------------------------------------------------------------------------
# Per-tile culling (plain PyTorch on every device, as it is XLA in JAX).


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


def _imul(x_lo, x_hi, r_lo, r_hi):
    """Interval product, with XLA's NaN-aware minimum and maximum."""
    c1, c2 = x_lo * r_lo, x_lo * r_hi
    c3, c4 = x_hi * r_lo, x_hi * r_hi
    return (_xmin(_xmin(c1, c2), _xmin(c3, c4)),
            _xmax(_xmax(c1, c2), _xmax(c3, c4)))


def _interval_slab(p_lo, p_hi, d_lo, d_hi, box_lo, box_hi):
    """Conservative slab test of each tile's ray interval box (origins in
    [p_lo, p_hi], directions in [d_lo, d_hi], (G, 3)) against the (C, 3)
    cluster boxes: ((G, C) pass, (G, C) entry = max(tmin, 0)). A
    direction range spanning 0 leaves its axis unconstrained."""
    g, c = p_lo.shape[0], box_lo.shape[0]
    dev = p_lo.device
    tmin = torch.full((g, c), -BIG, device=dev)
    tmax = torch.full((g, c), BIG, device=dev)
    for ax in range(3):
        bl, bh = box_lo[None, :, ax], box_hi[None, :, ax]
        plo, phi = p_lo[:, ax:ax + 1], p_hi[:, ax:ax + 1]
        dlo, dhi = d_lo[:, ax:ax + 1], d_hi[:, ax:ax + 1]
        spans_zero = (dlo <= 0.0) & (dhi >= 0.0)
        one = torch.ones_like(dhi)
        r_lo = torch.where(spans_zero, torch.full_like(dhi, -BIG), one / dhi)
        r_hi = torch.where(spans_zero, torch.full_like(dlo, BIG), one / dlo)
        t1_lo, t1_hi = _imul(bl - phi, bl - plo, r_lo, r_hi)
        t2_lo, t2_hi = _imul(bh - phi, bh - plo, r_lo, r_hi)
        tmin = _xmax(tmin, _xmin(t1_lo, t2_lo))
        tmax = _xmin(tmax, _xmax(t1_hi, t2_hi))
    hit = (tmax >= tmin) & (tmax >= 0.0)
    return hit, _xmax(tmin, torch.zeros_like(tmin))


def _tile_cluster_lists(rays8: torch.Tensor, boxes: torch.Tensor, tr: int):
    """Per tile of tr rays of the (Rpad, 8) rows: (ids (G, C) int32, the
    clusters in order of their entry bound, those the tile passes first;
    cnt (G, 1) int32, how many pass; entry (G, C) float32 sorted, BIG
    where not passed). The entry bound is the larger of the interval
    slab's and the distance from the tile's origin box to the cluster
    box (rays are unit length)."""
    rpad = rays8.shape[0]
    g = rpad // tr
    tiles = rays8.reshape(g, tr, 8)
    p_lo, p_hi = tiles[:, :, 0:3].amin(1), tiles[:, :, 0:3].amax(1)
    d_lo, d_hi = tiles[:, :, 3:6].amin(1), tiles[:, :, 3:6].amax(1)
    hit, entry = _interval_slab(p_lo, p_hi, d_lo, d_hi, boxes[:, 0:3],
                                boxes[:, 3:6])
    dist_sq = torch.zeros_like(entry)
    for ax in range(3):
        gap = _xmax(boxes[None, :, ax] - p_hi[:, ax:ax + 1],
                    p_lo[:, ax:ax + 1] - boxes[None, :, ax + 3])
        gap = _xmax(gap, torch.zeros_like(gap))
        dist_sq = fp.fma(gap, gap, dist_sq)
    entry = _xmax(entry, fp.sqrt(dist_sq))
    key = torch.where(hit, entry, torch.full_like(entry, BIG))
    entry_s, order = torch.sort(key, dim=1, stable=True)
    cnt = hit.sum(1, dtype=torch.int32)
    return order.to(torch.int32), cnt[:, None], entry_s


# -------------------------------------------------------------------------
# The skip rule's table, shared by K12, K17, K7, K6, K16, K14 and K15:
# the argument is in csrc/pair_vpu.cu, the slab test in csrc/sub_cull.cuh
# (SUB rows a sub-block).

_U = 2.0 ** -24
_KAPPA = 6 * _U   # the rule's coefficient of |P| + t |D|


def _cross(a, b):
    return np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                     a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                     a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _f32_down(x):
    """float64 -> the float32 at or below (nan stays nan)."""
    f = x.astype(np.float32)
    with np.errstate(invalid="ignore"):
        return np.where(f > x, np.nextafter(f, np.float32(-np.inf)), f)


def _f32_up(x):
    f = x.astype(np.float32)
    with np.errstate(invalid="ignore"):
        return np.where(f < x, np.nextafter(f, np.float32(np.inf)), f)


def _row_boxes(rows: np.ndarray):
    """The skip rule's per-row terms (the argument in csrc/pair_vpu.cu),
    float64, for (N, 24) triangle-pack rows: (zero, ok, lo (N, 3), hi (N, 3), G, Omega).
    zero: n = 0 (never accepted: the row is left out); ok: in the rule's
    ranges and a proper triangle, so that an accepted hit point X lies in
    [lo - G H, hi + G H], H = 6u (|P| + t |D|) + Omega."""
    r = rows[:, :16].astype(np.float64)
    n, c0 = r[:, 0:3], r[:, 3]
    m = np.stack([r[:, 4:7], r[:, 8:11], r[:, 12:15]], 1)      # (N, 3, 3)
    d = r[:, [7, 11, 15]]
    zero = ~(rows[:, 0:3] != 0).any(1)
    with np.errstate(all="ignore"):
        nn = np.sqrt((n * n).sum(1))
        mn = np.sqrt((m * m).sum(2))
        ok = (np.isfinite(r).all(1) & (np.abs(n).max(1) <= 2.0 ** 32)
              & (np.abs(m).max((1, 2)) <= 2.0 ** 32)
              & (np.abs(c0) <= 2.0 ** 100) & (np.abs(d).max(1) <= 2.0 ** 100)
              & (nn >= 2.0 ** -50) & (mn.min(1) >= 2.0 ** -50))
        nh = n / nn[:, None]
        ch = c0 / nn
        mh = m / mn[:, :, None]
        dh = d / mn
        nu = (mh * nh[:, None]).sum(2)                            # (N, 3)
        mu = mh - nu[:, :, None] * nh[:, None]
        beta = dh - nu * ch[:, None]
        cc = 1.0 + np.abs(nu)
        corners, moves = [], []
        for a, b, c in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
            ub, ua = _cross(mu[:, b], nh), _cross(mu[:, a], nh)
            det = (mu[:, a] * ub).sum(1)
            v = (beta[:, a, None] * ub - beta[:, b, None] * ua) / det[:, None]
            w = (cc[:, b, None] * ua - cc[:, a, None] * ub) / det[:, None]
            # The crossing of lines a and b strictly inside half-plane c
            # (beyond float64's rounding of it).
            res = (mu[:, c] * v).sum(1) - beta[:, c]
            tol = 2.0 ** -36 * (np.abs(beta[:, c]) + np.abs(v).sum(1))
            ok &= (np.abs(det) >= 2.0 ** -40) & (res > tol)
            corners.append(v + ch[:, None] * nh)
            moves.append(np.abs(w))
        corners = np.stack(corners, 1)                            # (N, 3, 3)
        g = (np.stack(moves, 1).max(1) + np.abs(nh)).max(1) * (1 + 2.0 ** -20)
        slack = 2.0 ** -30 * np.abs(corners).max((1, 2)) + 2.0 ** -90
        lo = corners.min(1) - slack[:, None]
        hi = corners.max(1) + slack[:, None]
        omega = np.maximum(2.01 * _U * np.abs(c0) / nn,
                           (1.01 * _U * np.abs(d) / mn).max(1)) + 2.0 ** -90
        ok &= np.isfinite(lo).all(1) & np.isfinite(hi).all(1) & (
            g * _KAPPA * np.sqrt(3.0) <= 0.5) & np.isfinite(omega)
    return zero, ok & ~zero, lo, hi, g, omega


def sub_boxes(rows: torch.Tensor, spans) -> torch.Tensor:
    """The skip rule's per-scene table for the (N, 24) triangle-pack rows
    cut into `spans`, (base, end) row ranges in order: each span's
    ceil((end - base) / SUB) sub-blocks of SUB consecutive rows from its
    base (the last partial; none straddles a span), in span order, as
    (S, 8) float32 [lo(3) A hi(3) Gp]: the union of the sub-block's row
    boxes rounded outward, and I = A + Gp |P|_1 the widening for a ray
    from P. A sub-block with a row the rule does not cover (not a proper
    triangle, or outside the rule's ranges) gets lo = -inf, hi = inf, A =
    inf (never skipped); one with only n = 0 rows, lo = inf, hi = -inf
    (always skipped). Built on the host, float64."""
    r = rows.detach().cpu().numpy()
    sp = np.asarray(spans, np.int64).reshape(-1, 2)
    size = sp[:, 1] - sp[:, 0]
    n_sb = -(-size // SUB)
    first = np.cumsum(n_sb) - n_sb
    idx = np.concatenate([np.arange(b, e) for b, e in sp])
    # Row -> sub-block index, then the per-sub-block reductions.
    sb = np.repeat(first, size) + (idx - np.repeat(sp[:, 0], size)) // SUB
    ns = int(n_sb.sum())
    zero, ok, lo, hi, g, omega = _row_boxes(r[idx])
    bad = ~zero & ~ok
    lo = np.where(ok[:, None], lo, np.inf)
    hi = np.where(ok[:, None], hi, -np.inf)
    g = np.where(ok, g, 0.0)
    omega = np.where(ok, omega, 0.0)
    blo = np.full((ns, 3), np.inf)
    bhi = np.full((ns, 3), -np.inf)
    np.minimum.at(blo, sb, lo)
    np.maximum.at(bhi, sb, hi)
    bg = np.zeros(ns)
    bom = np.zeros(ns)
    np.maximum.at(bg, sb, g)
    np.maximum.at(bom, sb, omega)
    nbad = np.zeros(ns, np.int64)
    np.add.at(nbad, sb, bad)
    empty = ~np.isfinite(blo).all(1)
    out = np.zeros((ns, 8), np.float32)
    out[:, 0:3] = np.where(empty[:, None], np.float32(np.inf), _f32_down(blo))
    out[:, 4:7] = np.where(empty[:, None], np.float32(-np.inf), _f32_up(bhi))
    with np.errstate(invalid="ignore", over="ignore"):
        # B: the largest norm of a corner of the (rounded) box.
        corner = np.maximum(np.abs(out[:, 0:3]), np.abs(out[:, 4:7]))
        big_b = np.sqrt((corner.astype(np.float64) ** 2).sum(1))
        gk = bg * _KAPPA
        a = (2.0 * bg * bom + 2.0 * gk * big_b) * (1 + 2.0 ** -40)
    out[:, 3] = np.where(empty, np.float32(0), _f32_up(a))
    out[:, 7] = np.where(empty, np.float32(0),
                         _f32_up(4.0 * gk * (1 + 2.0 ** -40)))
    never = nbad > 0
    out[never, 0:3] = -np.inf
    out[never, 4:7] = np.inf
    out[never, 3] = np.inf
    out[never, 7] = 0.0
    return torch.as_tensor(out, device=rows.device)


def cluster_sub_boxes(rows: torch.Tensor, k: int) -> torch.Tensor:
    """`sub_boxes` of the (C K, 24) cluster rows, one span per cluster:
    (C ceil(K / SUB), 8), cluster c's sub-blocks at [c ceil(K / SUB),
    (c + 1) ceil(K / SUB))."""
    c = rows.shape[0] // k
    return sub_boxes(rows, [(i * k, (i + 1) * k) for i in range(c)])


# -------------------------------------------------------------------------
# K17.


def cluster_plain(rays8: torch.Tensor, cnt: torch.Tensor, ids: torch.Tensor,
                  entry: torch.Tensor, rows: torch.Tensor, k: int, tr: int,
                  early_exit: bool):
    """Plain PyTorch version of K17: (6, Rpad) float32 rows [t (BIG on a
    miss), winner index c K + lane, nx, ny, nz, mati] for the (Rpad, 8)
    rays, tile by tile of tr (see the module docstring)."""
    rpad = rays8.shape[0]
    g = rpad // tr
    dev = rays8.device
    rays_t = rays8.reshape(g, tr, 8)
    best_t = torch.full((g, tr), BIG, device=dev)
    best_g = torch.zeros((g, tr), dtype=torch.int64, device=dev)
    cnt = cnt.reshape(g).long()
    live = torch.ones(g, dtype=torch.bool, device=dev)
    chunk = max(1, _PLAIN_CELLS // (tr * k))
    cmax = rows.shape[0] // k
    blocks = rows.reshape(cmax, k, TRI_COLS)
    for slot in range(int(cnt.max()) if g else 0):
        live &= slot < cnt
        if early_exit:
            live &= entry[:, slot] < best_t.amax(1)
        tiles = torch.nonzero(live).flatten()
        if tiles.numel() == 0:
            break
        for s in range(0, tiles.numel(), chunk):
            tl = tiles[s:s + chunk]
            ci = ids[tl, slot].long()
            tm, local = cluster_nearest(blocks[ci],
                                        rays_t[tl].transpose(1, 2))
            cur = best_t[tl]
            better = tm < cur
            best_t[tl] = torch.where(better, tm, cur)
            best_g[tl] = torch.where(better, ci[:, None] * k + local,
                                     best_g[tl])
    best_t, best_g = best_t.reshape(-1), best_g.reshape(-1)
    hit = best_t < BIG
    g_out = torch.where(hit, best_g, torch.zeros_like(best_g))
    return torch.stack([best_t, g_out.to(torch.float32),
                        *winner_attrs(rows, g_out, hit)])


def _check_cluster(rays8, cnt, ids, entry, rows, k, tr, sub, what):
    _build.check(rays8, "rays8", (None, 8))
    rpad = rays8.shape[0]
    if tr <= 0 or rpad % tr:
        raise ValueError(f"{what} needs Rpad ({rpad}) a multiple of tr "
                         f"({tr})")
    g = rpad // tr
    _build.check(rows, "rows", (None, TRI_COLS))
    c = rows.shape[0] // k if k > 0 else 0
    if c == 0 or rows.shape[0] != c * k:
        raise ValueError(f"rows ({rows.shape[0]}) must be C clusters of "
                         f"k = {k}")
    _build.check(cnt, "cnt", (g, 1), torch.int32)
    _build.check(ids, "ids", (g, c), torch.int32)
    _build.check(entry, "entry", (g, c))
    if sub is not None:
        _build.check(sub, "sub", (c * -(-k // SUB), 8))
    if any(x is not None and x.device != rays8.device
           for x in (cnt, ids, entry, rows, sub)):
        raise ValueError(f"{what}'s tensors must be on one device")
    if rays8.device.type == "cuda" and (tr > MAX_TILE or tr % 32):
        raise ValueError(f"K17 on the card takes tiles of a multiple of 32 "
                         f"rays, at most {MAX_TILE} (one CUDA block); "
                         f"tr = {tr}")
    return g, c


def run_cluster(rays8: torch.Tensor, cnt: torch.Tensor, ids: torch.Tensor,
                entry: torch.Tensor, rows: torch.Tensor, k: int, tr: int,
                early_exit: bool = False, sub: torch.Tensor | None = None):
    """K17: (t, index, nx, ny, nz, mati), six (Rpad,) float32 tensors, for
    the (Rpad, 8) ray rows, Rpad a multiple of tr, walking each tile's
    cluster list (cnt (G, 1) int32, ids and entry (G, C) from
    `_tile_cluster_lists`) over the (C K, 24) cluster rows. sub: the rows'
    `cluster_sub_boxes` table, which the kernel needs
    (`make_cluster_intersect` builds it once per scene; the plain version
    ignores it). CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    g, c = _check_cluster(rays8, cnt, ids, entry, rows, k, tr, sub,
                          "run_cluster")
    if rays8.device.type == "cpu":
        return tuple(cluster_plain(rays8, cnt, ids, entry, rows, k, tr,
                                   early_exit))
    if sub is None:
        raise ValueError("run_cluster on CUDA tensors needs sub, the rows' "
                         "cluster_sub_boxes table")
    out = torch.empty((6, rays8.shape[0]), dtype=torch.float32,
                      device=rays8.device)
    if g:
        _build.launch("cluster", rays8, cnt, ids, entry, rows, sub, out, g,
                      tr, c, k, int(early_exit), CLUSTER_COOP)
    return tuple(out)


def run_cluster_simt(rays8: torch.Tensor, cnt: torch.Tensor,
                     ids: torch.Tensor, entry: torch.Tensor,
                     rows: torch.Tensor, k: int, tr: int,
                     early_exit: bool = False):
    """K17's first kernel (`csrc/cluster.cu::cluster_simt_kernel`: every
    ray of a tile against every row of every listed cluster, staged for
    the block), on CUDA tensors: run_cluster's rows. For the checks only
    (the smoke and the cuda tests hold the new kernel against it on whole
    launches and time the two in turns); no render path calls it."""
    g, c = _check_cluster(rays8, cnt, ids, entry, rows, k, tr, None,
                          "run_cluster_simt")
    if rays8.device.type != "cuda":
        raise ValueError("run_cluster_simt runs on CUDA tensors only")
    out = torch.empty((6, rays8.shape[0]), dtype=torch.float32,
                      device=rays8.device)
    if g:
        _build.launch("cluster_simt", rays8, cnt, ids, entry, rows, out, g,
                      tr, c, k, int(early_exit))
    return tuple(out)


def run_cluster_counted(rays8: torch.Tensor, cnt: torch.Tensor,
                        ids: torch.Tensor, entry: torch.Tensor,
                        rows: torch.Tensor, k: int, tr: int,
                        early_exit: bool, sub: torch.Tensor):
    """run_cluster's kernel on CUDA tensors, also counting: (rows, (tests
    that reached the divide, (ray, sub-block) box tests that passed,
    those of them run by the whole warp, edge tests reached, box tests
    made)). For the checks only; no render path calls it."""
    g, c = _check_cluster(rays8, cnt, ids, entry, rows, k, tr, sub,
                          "run_cluster_counted")
    if rays8.device.type != "cuda":
        raise ValueError("run_cluster_counted runs on CUDA tensors only")
    out = torch.empty((6, rays8.shape[0]), dtype=torch.float32,
                      device=rays8.device)
    count = torch.zeros(5, dtype=torch.int64, device=rays8.device)
    if g:
        _build.launch("cluster_count", rays8, cnt, ids, entry, rows, sub,
                      out, g, tr, c, k, int(early_exit), CLUSTER_COOP, count)
    return tuple(out), tuple(int(x) for x in count.tolist())


def make_cluster_intersect(tris: TrianglesSoA, *, cluster_size: int = 128,
                           tr: int = 256, subtiles: int = 1,
                           early_exit: bool = False):
    """The 'cluster' accel: clusters built once (`build_clusters`);
    intersect(rays) -> Hits. Per call: the rays padded to a multiple of
    tr * subtiles, each tile's cluster list (`_tile_cluster_lists`), K17.
    `subtiles` (tiles per TPU grid step) changes no output. As in the
    JAX package, a miss keeps the kernel's zero normal."""
    scene, _, k = build_clusters(tris, cluster_size)
    rows = scene.rows()
    sub = cluster_sub_boxes(rows, k) if rows.device.type == "cuda" else None

    def intersect(rays: Rays) -> Hits:
        r = rays.count
        unit = tr * subtiles
        rpad = -(-r // unit) * unit
        rays8 = pack_rays_rows(rays.p, rays.d, rpad)
        ids, cnt, entry = _tile_cluster_lists(rays8, scene.boxes, tr)
        best_t, _, nx, ny, nz, m = run_cluster(rays8, cnt, ids, entry, rows,
                                               k, tr, early_exit, sub)
        best_t = best_t[:r]
        any_hit = best_t < BIG
        z = torch.zeros_like(best_t)
        safe_t = torch.where(any_hit, best_t, z)
        return Hits(
            t=torch.where(any_hit, best_t, torch.full_like(best_t, -1.0)),
            p=tuple(torch.where(any_hit, rays.p[j] + rays.d[j] * safe_t, z)
                    for j in range(3)),
            n=(nx[:r], ny[:r], nz[:r]),
            mati=torch.where(any_hit, m[:r], z).to(torch.int32),
        )

    return intersect
