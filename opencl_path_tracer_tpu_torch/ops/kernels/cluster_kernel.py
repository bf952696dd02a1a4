"""K17: the two-level cluster intersector (`accel='cluster'`), and the
Morton cluster packs and cluster-block test that K12 and K16 share.

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
result depends on.
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
    BIG, TRI_COLS, build_tri_pack, exact_test,
)

_PLAIN_CELLS = 1 << 22    # (ray, triangle) tests per chunk of a plain version
MAX_TILE = 1024   # rays per tile K17 takes on the card (one CUDA block)


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


def run_cluster(rays8: torch.Tensor, cnt: torch.Tensor, ids: torch.Tensor,
                entry: torch.Tensor, rows: torch.Tensor, k: int, tr: int,
                early_exit: bool = False):
    """K17: (t, index, nx, ny, nz, mati), six (Rpad,) float32 tensors, for
    the (Rpad, 8) ray rows, Rpad a multiple of tr, walking each tile's
    cluster list (cnt (G, 1) int32, ids and entry (G, C) from
    `_tile_cluster_lists`) over the (C K, 24) cluster rows. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    _build.check(rays8, "rays8", (None, 8))
    rpad = rays8.shape[0]
    if tr <= 0 or rpad % tr:
        raise ValueError(f"run_cluster needs Rpad ({rpad}) a multiple of "
                         f"tr ({tr})")
    g = rpad // tr
    _build.check(rows, "rows", (None, TRI_COLS))
    c = rows.shape[0] // k if k > 0 else 0
    if c == 0 or rows.shape[0] != c * k:
        raise ValueError(f"rows ({rows.shape[0]}) must be C clusters of "
                         f"k = {k}")
    _build.check(cnt, "cnt", (g, 1), torch.int32)
    _build.check(ids, "ids", (g, c), torch.int32)
    _build.check(entry, "entry", (g, c))
    if any(x.device != rays8.device for x in (cnt, ids, entry, rows)):
        raise ValueError("run_cluster's tensors must be on one device")
    if rays8.device.type == "cpu":
        return tuple(cluster_plain(rays8, cnt, ids, entry, rows, k, tr,
                                   early_exit))
    if tr > MAX_TILE or tr % 32:
        raise ValueError(f"K17 on the card takes tiles of a multiple of 32 "
                         f"rays, at most {MAX_TILE} (one CUDA block); "
                         f"tr = {tr}")
    out = torch.empty((6, rpad), dtype=torch.float32, device=rays8.device)
    if g:
        _build.launch("cluster", rays8, cnt, ids, entry, rows, out, g, tr,
                      c, k, int(early_exit))
    return tuple(out)


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

    def intersect(rays: Rays) -> Hits:
        r = rays.count
        unit = tr * subtiles
        rpad = -(-r // unit) * unit
        rays8 = pack_rays_rows(rays.p, rays.d, rpad)
        ids, cnt, entry = _tile_cluster_lists(rays8, scene.boxes, tr)
        best_t, _, nx, ny, nz, m = run_cluster(rays8, cnt, ids, entry, rows,
                                               k, tr, early_exit)
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
