"""K6: the tile-culled nearest hit, and K7: the any-hit shadow-ray test
(CUDA kernels and plain versions), with the intersectors built on them.

Port of `opencl_path_tracer_tpu/ops/pallas/tilecull_kernel.py`:
`build_groups`, `_safe_inv`, `_slab`, `_tilecull_kernel` (launched by
`_run_tilecull`) with `make_tilecull_intersect`, and `_anyhit_kernel`
(launched by `_run_anyhit`) with `make_anyhit_occluded` and
`make_scene_occluded`, the presort (`_presort_perm`, the `presort`
modes of `make_tilecull_intersect`) and the host predictor of the auto
accel (`_np_brute`, `estimate_tile_need_fraction`, `auto_small_accel`).

presort='octant' or 'morton' permutes the rays into coherent runs before
K6 (a stable sort on the direction octant, or on the octant above the
origin's Morton cell in the groups' bounds) and gathers K6's and K2's
rows back to the caller's order after. K6 picks each ray's winner on its
own, so the Hits and ids are those of presort='none' bit for bit.

The predictor samples the camera's rays on the host in float64 (32
blocks of 32 x 32 pixels and one cosine bounce from their hits, the
same `default_rng(seed)` draws in the same order as the JAX package)
and returns the mean share of the groups a tile of 1,024 of those rays
needs; `auto_small_accel` picks 'tilecull' below its threshold. The
engine sets that threshold from an H100 measurement
(`runtime/engine.py::AUTO_TILECULL_THRESHOLD`); the function keeps the
JAX package's default.

The triangles are put in 10-bit Morton order of their centroids and cut
into groups of `gs` rows, each with an axis-aligned box inflated by
1e-4 of the scene's extent (plus 1e-7), so that the float32 slab test
never drops a triangle the exact test accepts. Per ray and group:
tn, tf = the slab's entry and exit; K6 tests a group's rows only where
tf >= tn, tf >= 0 and tn < best t, K7 only where tf >= tn, tf >= 0,
tn <= rmax and the ray is not yet occluded. The row test is K1's, op for
op (`intersect_kernel.minarg_plain`, `csrc/nearest.cuh`), so K6's t is
K1's t on the same rays, and K7's flag is (t valid and t < rmax) of the
nearest hit. Groups are scanned in order and rows in order with a strict
<, so K6's winner on exact-t ties is the first in Morton order, however
coarsely a kernel skips groups: a skipped group has no hit below its tn.

The plain versions apply the culling lane by lane; the TPU kernels skip
a group for a 1,024-ray tile only when no lane needs it, the CUDA
kernels for a warp of 32; inside a group it needs, a ray also skips each
sub-block of `SUB` rows whose box (`anyhit_sub_boxes`, built once per
scene) its segment misses, to its running best t (K6) or to rmax (K7),
which the skip rule proves holds no accepted t at or below that bound
(csrc/tilecull.cu, csrc/anyhit.cu). All give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.types import Rays
from opencl_path_tracer_tpu_torch.models.wavefront import morton3_components
from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.ops.kernels.cluster_kernel import (
    SUB, sub_boxes,
)
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    BIG, TRI_COLS, assemble_hits, build_tri_pack, exact_test, pack_rays,
)
from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import refine1
from opencl_path_tracer_tpu_torch.ops.kernels.sphere_kernel import (
    make_sphere_intersect,
)

MAX_GROUPS = 64
GROUP_COLS = 8   # [lo_x lo_y lo_z hi_x hi_y hi_z base end]
# K7's warp tests a sub-block for at most this many of its rays together,
# all 32 lanes on one ray's rows (csrc/anyhit.cu); for more, each lane
# tests its own ray. 16 and 12 measured within 0.5 % on the Cornell
# bounce-0 and bounce-1 shadow rays, 4 and 8 slower (runtime/cull_ab.py
# --coop; PERF.md).
ANYHIT_COOP = 16
# K6's warp likewise (csrc/tilecull.cu): 12, 16 and 24 measured within
# 0.7 % on the Cornell camera and first-bounce rays, 8 1-3 % slower and 32
# up to 2.3x (runtime/cull_ab.py --coop; PERF.md).
TILECULL_COOP = 16


def build_groups(tris: TrianglesSoA, gs: int = 128, origin=None):
    """Morton-order the triangles and cut them into contiguous groups of
    `gs`, one padded box each, on the host in float64 as the JAX package
    does. Returns (tris_reordered, perm, boxes, spans): perm[i] is the
    original index of row i (int32 numpy); boxes a list of ((lo), (hi))
    python floats; spans a list of (base, end) rows. origin (the camera
    eye) also orders the groups front to back by the distance of their
    box centres from it."""
    r1 = tris.r1.cpu().numpy().astype(np.float64)
    r2 = tris.r2.cpu().numpy().astype(np.float64)
    r3 = tris.r3.cpu().numpy().astype(np.float64)
    t_count = r1.shape[0]
    if t_count == 0:
        raise ValueError("build_groups needs at least one triangle")
    cen = (r1 + r2 + r3) / 3.0
    lo = np.minimum(np.minimum(r1.min(0), r2.min(0)), r3.min(0))
    hi = np.maximum(np.maximum(r1.max(0), r2.max(0)), r3.max(0))
    extent = np.maximum(hi - lo, 1e-12)
    q = np.clip((cen - lo) / extent, 0.0, 1.0)
    cells = np.minimum((q * 1024.0).astype(np.uint64), 1023)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        return (x | (x << 2)) & np.uint64(0x09249249)

    code = ((spread(cells[:, 0]) << np.uint64(2))
            | (spread(cells[:, 1]) << np.uint64(1)) | spread(cells[:, 2]))
    perm = np.argsort(code, kind="stable").astype(np.int32)
    pad = 1e-4 * float(extent.max()) + 1e-7
    group_rows = [perm[g0:min(g0 + gs, t_count)]
                  for g0 in range(0, t_count, gs)]

    def box(rows):
        return (np.minimum(np.minimum(r1[rows].min(0), r2[rows].min(0)),
                           r3[rows].min(0)),
                np.maximum(np.maximum(r1[rows].max(0), r2[rows].max(0)),
                           r3[rows].max(0)))

    if origin is not None:
        o = np.asarray(origin, np.float64)
        group_rows.sort(key=lambda rows: float(
            np.linalg.norm(0.5 * (box(rows)[0] + box(rows)[1]) - o)))
        perm = np.concatenate(group_rows).astype(np.int32)
    boxes, spans, base = [], [], 0
    for rows in group_rows:
        blo, bhi = box(rows)
        boxes.append((tuple(float(v) for v in blo - pad),
                      tuple(float(v) for v in bhi + pad)))
        spans.append((base, base + len(rows)))
        base += len(rows)
    return tris.take(perm), perm, boxes, spans


def group_table(boxes, spans, device) -> torch.Tensor:
    """(G, 8) float32 rows [lo hi base end]: the boxes rounded to float32
    as the TPU kernel's baked constants are, and the spans (exact up to
    2^24 rows)."""
    rows = [list(lo) + list(hi) + [b, e]
            for (lo, hi), (b, e) in zip(boxes, spans)]
    return torch.tensor(np.asarray(rows, np.float32), device=device)


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1 / d with |d| < 1e-30 clamped to +-1e-30 (no inf * 0 NaNs)."""
    tiny = 1e-30
    s = torch.where(d < 0.0, torch.full_like(d, -tiny),
                    torch.full_like(d, tiny))
    return 1.0 / torch.where(torch.abs(d) < tiny, s, d)


def _slab(p, inv, lo, hi):
    """Per-lane (t_near, t_far) of the rays (origins p, reciprocal
    directions inv) against the box [lo, hi]."""
    t1 = [(lo[k] - p[k]) * inv[k] for k in range(3)]
    t2 = [(hi[k] - p[k]) * inv[k] for k in range(3)]
    mn = [torch.minimum(a, b) for a, b in zip(t1, t2)]
    mx = [torch.maximum(a, b) for a, b in zip(t1, t2)]
    tn = torch.maximum(torch.maximum(mn[0], mn[1]), mn[2])
    tf = torch.minimum(torch.minimum(mx[0], mx[1]), mx[2])
    return tn, tf


def tilecull_plain(rays8: torch.Tensor, tri_pack: torch.Tensor,
                   groups: torch.Tensor, ray_chunk: int = 8192):
    """Plain PyTorch version of K6: (t, g), two (R,) float32 tensors, t
    BIG and g 0 on a miss; g indexes the Morton-ordered pack."""
    r = rays8.shape[1]
    t_out = torch.empty(r, dtype=torch.float32, device=rays8.device)
    g_out = torch.empty(r, dtype=torch.float32, device=rays8.device)
    gl = groups.cpu().tolist()
    for s in range(0, r, ray_chunk):
        rays = rays8[:, s:s + ray_chunk]
        inv = [_safe_inv(x) for x in rays[3:6]]
        best_t = torch.full_like(rays[0], BIG)
        best_g = torch.zeros_like(best_t)
        for row in gl:
            tn, tf = _slab(rays[0:3], inv, row[0:3], row[3:6])
            need = (tf >= tn) & (tf >= 0.0) & (tn < best_t)
            if not bool(need.any()):
                continue
            base, end = int(row[6]), int(row[7])
            t, valid = exact_test(tri_pack[base:end], rays)
            tm = torch.where(valid & need[None], t, torch.full_like(t, BIG))
            m, a = torch.min(tm, dim=0)        # first index on ties
            bet = m < best_t
            best_t = torch.where(bet, m, best_t)
            best_g = torch.where(bet, (a + base).to(torch.float32), best_g)
        t_out[s:s + ray_chunk] = best_t
        g_out[s:s + ray_chunk] = best_g
    return t_out, g_out


def anyhit_plain(rays8: torch.Tensor, rmax: torch.Tensor,
                 tri_pack: torch.Tensor, groups: torch.Tensor,
                 ray_chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of K7: (R,) bool, True where some
    triangle's exact hit lies in (0, rmax)."""
    r = rays8.shape[1]
    out = torch.empty(r, dtype=torch.bool, device=rays8.device)
    gl = groups.cpu().tolist()
    for s in range(0, r, ray_chunk):
        rays = rays8[:, s:s + ray_chunk]
        rm = rmax[s:s + ray_chunk]
        inv = [_safe_inv(x) for x in rays[3:6]]
        occ = torch.zeros_like(rm, dtype=torch.bool)
        for row in gl:
            tn, tf = _slab(rays[0:3], inv, row[0:3], row[3:6])
            need = (tf >= tn) & (tf >= 0.0) & (tn <= rm) & ~occ
            if not bool(need.any()):
                continue
            base, end = int(row[6]), int(row[7])
            t, valid = exact_test(tri_pack[base:end], rays)
            occ |= need & (valid & (t < rm[None])).any(dim=0)
        out[s:s + ray_chunk] = occ
    return out


def _check_groups(tri_pack, groups):
    _build.check(tri_pack, "tri_pack", (None, TRI_COLS))
    _build.check(groups, "groups", (None, GROUP_COLS))
    if not 0 < groups.shape[0] <= MAX_GROUPS:
        raise ValueError(f"{groups.shape[0]} groups: K6 and K7 take 1 to "
                         f"{MAX_GROUPS}")
    if not 0 < tri_pack.shape[0] < 1 << 24:
        raise ValueError("K6 and K7 need 1 to 2^24 - 1 triangles (the "
                         "winner index travels as an exact float32)")


def _check_sub(sub, tri_pack, groups, what):
    """Refuse a table that cannot be `anyhit_sub_boxes` of these groups:
    spans covering the T rows cut into G groups make between ceil(T /
    SUB) and (T + (SUB - 1) G) // SUB sub-blocks. (The spans themselves
    are not read: that would copy the table back from the card on every
    call; the kernels never skip a sub-block past the table's end.)"""
    _build.check(sub, "sub", (None, 8))
    if sub.device != tri_pack.device:
        raise ValueError(f"{what}'s sub must be on the pack's device")
    t, g = tri_pack.shape[0], groups.shape[0]
    lo, hi = -(-t // SUB), (t + (SUB - 1) * g) // SUB
    if not lo <= sub.shape[0] <= hi:
        raise ValueError(f"{what}'s sub has {sub.shape[0]} rows: the "
                         f"anyhit_sub_boxes table of {t} rows in {g} groups "
                         f"has {lo} to {hi}")


def _check_tilecull(rays8, tri_pack, groups, sub, what):
    _build.check_rows(rays8, "rays8", 8)
    _check_groups(tri_pack, groups)
    if not (rays8.device == tri_pack.device == groups.device):
        raise ValueError(f"{what}'s rays8, tri_pack and groups must be on "
                         "one device")
    if sub is not None:
        _check_sub(sub, tri_pack, groups, what)
    return rays8.shape[1]


def tilecull(rays8: torch.Tensor, tri_pack: torch.Tensor,
             groups: torch.Tensor, sub: torch.Tensor | None = None):
    """K6: (t, g) for each ray of the (8, R) pack against the Morton-
    ordered (T, 24) pack and its (G, 8) group table. sub: the pack's
    `anyhit_sub_boxes` table, which the kernel needs
    (`make_tilecull_intersect` builds it once per scene; the plain
    version ignores it). CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    r = _check_tilecull(rays8, tri_pack, groups, sub, "tilecull")
    if rays8.device.type == "cpu":
        return tilecull_plain(rays8, tri_pack, groups)
    if sub is None:
        raise ValueError("tilecull on CUDA tensors needs sub, the pack's "
                         "anyhit_sub_boxes table")
    t = torch.empty(r, dtype=torch.float32, device=rays8.device)
    g = torch.empty(r, dtype=torch.float32, device=rays8.device)
    _build.launch("tilecull", rays8, rays8.stride(0), tri_pack, groups, sub,
                  t, g, r, groups.shape[0], sub.shape[0], TILECULL_COOP)
    return t, g


def tilecull_simt(rays8: torch.Tensor, tri_pack: torch.Tensor,
                  groups: torch.Tensor):
    """K6's first kernel (`csrc/tilecull.cu::tilecull_simt_kernel`: a
    group's rows staged for the block where any of its rays needs it), on
    CUDA tensors: tilecull's (t, g). For the checks only (the smoke and
    the cuda tests hold the new kernel against it on whole launches and
    time the two in turns); no render path calls it."""
    r = _check_tilecull(rays8, tri_pack, groups, None, "tilecull_simt")
    if rays8.device.type != "cuda":
        raise ValueError("tilecull_simt runs on CUDA tensors only")
    t = torch.empty(r, dtype=torch.float32, device=rays8.device)
    g = torch.empty(r, dtype=torch.float32, device=rays8.device)
    _build.launch("tilecull_simt", rays8, rays8.stride(0), tri_pack, groups,
                  t, g, r, groups.shape[0])
    return t, g


def tilecull_counted(rays8: torch.Tensor, tri_pack: torch.Tensor,
                     groups: torch.Tensor, sub: torch.Tensor):
    """tilecull's kernel on CUDA tensors, also counting: ((t, g), (tests
    that reached the divide, (ray, sub-block) box tests that passed,
    those of them run by the whole warp, edge tests reached, group slab
    and box tests made)). For the checks only; no render path calls
    it."""
    r = _check_tilecull(rays8, tri_pack, groups, sub, "tilecull_counted")
    if rays8.device.type != "cuda":
        raise ValueError("tilecull_counted runs on CUDA tensors only")
    t = torch.empty(r, dtype=torch.float32, device=rays8.device)
    g = torch.empty(r, dtype=torch.float32, device=rays8.device)
    count = torch.zeros(5, dtype=torch.int64, device=rays8.device)
    _build.launch("tilecull_count", rays8, rays8.stride(0), tri_pack, groups,
                  sub, t, g, r, groups.shape[0], sub.shape[0], TILECULL_COOP,
                  count)
    return (t, g), tuple(int(x) for x in count.tolist())


def anyhit_sub_boxes(tri_pack: torch.Tensor, groups: torch.Tensor):
    """K6's and K7's table of the skip rule (`cluster_kernel.sub_boxes`)
    for the Morton-ordered pack cut into its groups' spans: (S, 8), each
    group's ceil(rows / SUB) sub-blocks in table order."""
    spans = groups[:, 6:8].cpu().numpy().astype(np.int64)
    return sub_boxes(tri_pack, spans)


def _check_anyhit(rays8, rmax, tri_pack, groups, sub, what):
    _build.check_rows(rays8, "rays8", 8)
    r = rays8.shape[1]
    _build.check(rmax, "rmax", (r,))
    _check_groups(tri_pack, groups)
    if not (rays8.device == rmax.device == tri_pack.device == groups.device):
        raise ValueError(f"{what}'s rays8, rmax, tri_pack and groups must "
                         "be on one device")
    if sub is not None:
        _check_sub(sub, tri_pack, groups, what)
    return r


def anyhit(rays8: torch.Tensor, rmax: torch.Tensor, tri_pack: torch.Tensor,
           groups: torch.Tensor, sub: torch.Tensor | None = None
           ) -> torch.Tensor:
    """K7: (R,) bool occlusion flags for the (8, R) pack with segment
    lengths rmax (R,) against the Morton-ordered pack and its group
    table. sub: the pack's `anyhit_sub_boxes` table, which the kernel
    needs (`make_anyhit_occluded` builds it once per scene; the plain
    version ignores it). CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    r = _check_anyhit(rays8, rmax, tri_pack, groups, sub, "anyhit")
    if rays8.device.type == "cpu":
        return anyhit_plain(rays8, rmax, tri_pack, groups)
    if sub is None:
        raise ValueError("anyhit on CUDA tensors needs sub, the pack's "
                         "anyhit_sub_boxes table")
    occ = torch.empty(r, dtype=torch.bool, device=rays8.device)
    _build.launch("anyhit", rays8, rays8.stride(0), rmax, tri_pack, groups,
                  sub, occ, r, groups.shape[0], sub.shape[0], ANYHIT_COOP)
    return occ


def anyhit_simt(rays8: torch.Tensor, rmax: torch.Tensor,
                tri_pack: torch.Tensor, groups: torch.Tensor) -> torch.Tensor:
    """K7's first kernel (`csrc/anyhit.cu::anyhit_simt_kernel`: a group's
    rows staged for the block where any of its rays needs it), on CUDA
    tensors: anyhit's flags. For the checks only (the smoke and the cuda
    tests hold the new kernel against it on whole launches and time the
    two in turns); no render path calls it."""
    r = _check_anyhit(rays8, rmax, tri_pack, groups, None, "anyhit_simt")
    if rays8.device.type != "cuda":
        raise ValueError("anyhit_simt runs on CUDA tensors only")
    occ = torch.empty(r, dtype=torch.bool, device=rays8.device)
    _build.launch("anyhit_simt", rays8, rays8.stride(0), rmax, tri_pack,
                  groups, occ, r, groups.shape[0])
    return occ


def anyhit_counted(rays8: torch.Tensor, rmax: torch.Tensor,
                   tri_pack: torch.Tensor, groups: torch.Tensor,
                   sub: torch.Tensor):
    """anyhit's kernel on CUDA tensors, also counting: (flags, (tests
    that reached the divide, (ray, sub-block) box tests that passed,
    those of them run by the whole warp, edge tests reached, group slab
    and box tests made)). For the checks only; no render path calls
    it."""
    r = _check_anyhit(rays8, rmax, tri_pack, groups, sub, "anyhit_counted")
    if rays8.device.type != "cuda":
        raise ValueError("anyhit_counted runs on CUDA tensors only")
    occ = torch.empty(r, dtype=torch.bool, device=rays8.device)
    count = torch.zeros(5, dtype=torch.int64, device=rays8.device)
    _build.launch("anyhit_count", rays8, rays8.stride(0), rmax, tri_pack,
                  groups, sub, occ, r, groups.shape[0], sub.shape[0],
                  ANYHIT_COOP, count)
    return occ, tuple(int(x) for x in count.tolist())


def _pack_groups(tris, tris2, boxes, spans, gs):
    """(pack, groups) of `build_groups`' output, for K6 and K7."""
    if len(boxes) > MAX_GROUPS:
        raise ValueError(
            f"{tris.count} tris -> {len(boxes)} groups exceeds MAX_GROUPS="
            f"{MAX_GROUPS} at gs={gs}; scenes this large need the pair "
            "intersector, ported as accel 'pairwin' or 'pair'")
    return build_tri_pack(tris2), group_table(boxes, spans, tris.device)


def grouped_pack(tris: TrianglesSoA, gs: int = 128, origin=None):
    """(pack, groups, perm): the Morton-ordered (T, 24) pack, its (G, 8)
    group table on the triangles' device, for K6 and K7, and the
    permutation."""
    tris2, perm, boxes, spans = build_groups(tris, gs, origin=origin)
    return (*_pack_groups(tris, tris2, boxes, spans, gs), perm)


PRESORTS = ("none", "octant", "morton")


def _presort_perm(rays: Rays, mode: str, scene_lo, scene_inv
                  ) -> torch.Tensor:
    """(R,) int64 lane permutation that groups coherent rays: a stable
    sort on the direction octant ('octant'), or on octant << 27 | the
    origin's 30-bit Morton cell >> 3 in the box (scene_lo, 1 /
    scene_inv) ('morton'). The JAX package sorts padded lanes, which
    sort after every real one, so its first R entries are this."""
    octant = ((rays.d[0] >= 0).long() * 4 + (rays.d[1] >= 0).long() * 2
              + (rays.d[2] >= 0).long())
    if mode == "octant":
        key = octant
    else:
        q = tuple(torch.clamp((rays.p[k] - scene_lo[k]) * scene_inv[k],
                              0.0, 1.0) for k in range(3))
        key = (octant << 27) | (morton3_components(q) >> 3)
    return torch.sort(key, stable=True).indices


def make_tilecull_intersect(tris: TrianglesSoA, *, gs: int = 128,
                            with_ids: bool = False, presort: str = "none",
                            origin=None):
    """The 'tilecull' accel: K6, then K2's attribute fetch on the Morton-
    ordered pack. intersect(rays) -> Hits, or (Hits, ids) with ids the
    winner's original triangle index (-1 on a miss) when with_ids=True.
    origin (the camera eye) orders the groups front to back. On exact-t
    ties the winner is the first in Morton order, where K1's is the first
    in scene order; t is the same. presort ('none', 'octant' or
    'morton', `_presort_perm`) runs K6 and K2 on the rays permuted and
    gathers their rows back with one inverse gather; the results are
    presort='none''s. The Morton-ordered pack, its groups and, on the
    card, K6's table of the skip rule (`anyhit_sub_boxes`) are built once
    here."""
    if presort not in PRESORTS:
        raise ValueError(f"unknown presort {presort!r}")
    tris2, perm, boxes, spans = build_groups(tris, gs, origin=origin)
    pack, groups = _pack_groups(tris, tris2, boxes, spans, gs)
    perm_t = torch.as_tensor(perm, device=tris.device)
    sub = (anyhit_sub_boxes(pack, groups) if pack.device.type == "cuda"
           else None)
    scene_lo = scene_inv = None
    if presort == "morton":
        # The key's box: the groups' padded boxes, in float64 as the JAX
        # package takes it, then rounded to float32 by the arithmetic.
        bx = np.asarray(boxes, np.float64)
        blo, bhi = bx[:, 0, :].min(axis=0), bx[:, 1, :].max(axis=0)
        scene_lo = tuple(float(v) for v in blo)
        scene_inv = tuple(float(v)
                          for v in 1.0 / np.maximum(bhi - blo, 1e-12))

    def intersect(rays: Rays):
        if presort == "none":
            t1, g1 = tilecull(pack_rays(rays.p, rays.d), pack, groups, sub)
            rows = refine1(t1, g1, pack)
        else:
            lane = _presort_perm(rays, presort, scene_lo, scene_inv)
            rays8 = pack_rays(rays.p, rays.d)[:, lane].contiguous()
            t1, g1 = tilecull(rays8, pack, groups, sub)
            out = torch.stack([*refine1(t1, g1, pack), g1])
            inv = torch.empty_like(lane)
            inv[lane] = torch.arange(lane.shape[0], device=lane.device)
            out = out[:, inv]
            rows, g1 = tuple(out[:5]), out[5]
        hits = assemble_hits(rays, rays.count, *rows)
        if not with_ids:
            return hits
        ids = torch.where(hits.valid, perm_t[g1.long()],
                          torch.full_like(perm_t[:1], -1))
        return hits, ids.to(torch.int32)

    return intersect


def make_anyhit_occluded(tris: TrianglesSoA, *, gs: int = 128):
    """occluded(rays, rmax) -> (R,) bool through K7: True iff some
    triangle's exact hit lies in (0, rmax). With rmax = dist (1 - 1e-3)
    it answers NEE's visibility exactly as the nearest hit does. The
    Morton-ordered pack, its groups and, on the card, K7's table of the
    skip rule (`anyhit_sub_boxes`) are built once here."""
    pack, groups, _ = grouped_pack(tris, gs)
    sub = (anyhit_sub_boxes(pack, groups) if pack.device.type == "cuda"
           else None)

    def occluded(rays: Rays, rmax: torch.Tensor) -> torch.Tensor:
        return anyhit(pack_rays(rays.p, rays.d), rmax.to(torch.float32)
                      .contiguous(), pack, groups, sub)

    return occluded


def make_scene_occluded(scene, *, gs: int = 128):
    """Whole-scene occlusion for NEE shadow rays: K7 over the triangles,
    OR a sphere hit with t < rmax (K3, or K3b above 64 spheres), as the
    merged nearest hit would decide. Returns occluded(rays, rmax) ->
    (R,) bool, or None for a scene above gs * MAX_GROUPS triangles: the
    JAX package's own choice, and the caller then sends the shadow rays
    through the nearest-hit intersector. It is not a fallback from a
    kernel that fails. (The port's scenes always have triangles, so JAX's
    sphere-only branch has no counterpart.)"""
    if scene.tris.count > gs * MAX_GROUPS:
        return None
    tri_occ = make_anyhit_occluded(scene.tris, gs=gs)
    if scene.spheres is None:
        return tri_occ
    sph = make_sphere_intersect(scene.spheres)

    def occluded(rays: Rays, rmax) -> torch.Tensor:
        h = sph(rays)
        return tri_occ(rays, rmax) | (h.valid & (h.t < rmax))

    return occluded


# The host predictor of the auto accel: the share of K6's group tests
# that the camera's own rays need, sampled on the host.


def _np_brute(tris: TrianglesSoA, P: np.ndarray, D: np.ndarray):
    """Nearest hit (t, triangle index) of the (N, 3) float64 rays by the
    exact test's math in numpy float64; t = inf and index -1 on a miss.
    For the predictor's small batches."""
    def f64(a):
        return a.cpu().numpy().astype(np.float64)

    nrm, c0 = f64(tris.n), f64(tris.c0)
    m = [f64(getattr(tris, f"m{k}")) for k in (1, 2, 3)]
    dk = [f64(getattr(tris, f"d{k}")) for k in (1, 2, 3)]
    best_t = np.full(P.shape[0], np.inf)
    best_i = np.full(P.shape[0], -1, np.int64)
    for i0 in range(0, P.shape[0], 256):
        p, d = P[i0:i0 + 256], D[i0:i0 + 256]
        vn = d @ nrm.T
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (c0[None, :] - p @ nrm.T) / vn
        ok = (t > 1e-9) & np.isfinite(t)
        for mk, dkk in zip(m, dk):
            ok &= (p @ mk.T) + t * (d @ mk.T) >= dkk[None, :]
        tm = np.where(ok, t, np.inf)
        best_t[i0:i0 + 256] = tm.min(axis=1)
        best_i[i0:i0 + 256] = tm.argmin(axis=1)
    best_i[~np.isfinite(best_t)] = -1
    return best_t, best_i


def estimate_tile_need_fraction(tris: TrianglesSoA, cam, *, gs: int = 128,
                                iterations: int = 5, n_tiles: int = 32,
                                seed: int = 0) -> float:
    """The predicted share of K6's group tests against all of them, on a
    sample of the camera's workload: n_tiles random 32 x 32-pixel blocks
    of camera rays and one cosine-sampled bounce from their hits, each
    block's need the union over its 1,024 rays of the groups whose
    padded box its slab test passes. iterations == 1 weighs the camera
    rays alone; deeper, camera : bounce = 0.3 : 0.7. Host numpy float64,
    the JAX package's function draw for draw."""
    rs = np.random.default_rng(seed)
    _t2, _perm, boxes, _spans = build_groups(tris, gs)

    def host(v):
        return np.asarray(v.cpu().numpy(), np.float64)

    eye, lookat = host(cam.eye), host(cam.lookat)
    upv, rightv = host(cam.up), host(cam.right)
    W, H = float(cam.xm), float(cam.ym)

    def tile_need(P, D, k):
        tiny = 1e-30
        inv = 1.0 / np.where(np.abs(D) < tiny, tiny, D)
        need = 0.0
        n_t = P.shape[0] // k
        for lo, hi in boxes:
            t1 = (np.asarray(lo)[None, :] - P) * inv
            t2 = (np.asarray(hi)[None, :] - P) * inv
            tn = np.minimum(t1, t2).max(axis=1)
            tf = np.maximum(t1, t2).min(axis=1)
            hit = (tf >= tn) & (tf >= 0.0)
            need += hit.reshape(n_t, k).any(axis=1).mean()
        return need / len(boxes)

    k = 1024
    bs = 32  # a block of 32 x 32 pixels: one tile of 1,024 rays
    xs = rs.integers(0, max(int(W) - bs, 1), size=n_tiles)
    ys = rs.integers(0, max(int(H) - bs, 1), size=n_tiles)
    px = (xs[:, None, None] + np.arange(bs)[None, :, None]
          + rs.random((n_tiles, bs, bs))).reshape(-1)
    py = (ys[:, None, None] + np.arange(bs)[None, None, :]
          + rs.random((n_tiles, bs, bs))).reshape(-1)
    pl_ = (lookat[None, :]
           + rightv[None, :] * (2.0 * px / W - 1.0)[:, None]
           + upv[None, :] * (2.0 * py / H - 1.0)[:, None])
    D0 = pl_ - eye[None, :]
    D0 /= np.maximum(np.linalg.norm(D0, axis=1, keepdims=True), 1e-12)
    P0 = np.broadcast_to(eye[None, :], D0.shape).copy()
    frac_p = tile_need(P0, D0, k)
    if iterations <= 1:
        return float(frac_p)

    t_hit, i_hit = _np_brute(tris, P0, D0)
    hit = i_hit >= 0
    if not hit.any():
        return float(frac_p)
    Ph = P0 + np.where(hit, t_hit, 0.0)[:, None] * D0
    Nv = tris.n.cpu().numpy().astype(np.float64)[np.maximum(i_hit, 0)]
    # Flipped toward the incoming ray, as the renderer does
    # (prog.cl:326-328).
    Nv = np.where((Nv * D0).sum(1, keepdims=True) > 0, -Nv, Nv)
    a = np.cross(Nv, np.where(np.abs(Nv[:, :1]) < 0.9,
                              [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]))
    a /= np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)
    b = np.cross(Nv, a)
    n = Ph.shape[0]
    r_ = np.sqrt(rs.random((n, 1)))
    th = 2.0 * np.pi * rs.random((n, 1))
    D1 = (r_ * np.cos(th) * a + r_ * np.sin(th) * b
          + np.sqrt(np.maximum(1.0 - r_ ** 2, 0.0)) * Nv)
    P1 = Ph + 1e-3 * D1
    # A lane that missed starts a new camera ray in the wavefront.
    P1 = np.where(hit[:, None], P1, P0)
    D1 = np.where(hit[:, None], D1, D0)
    frac_b = tile_need(P1, D1, k)
    return float(0.3 * frac_p + 0.7 * frac_b)


def auto_small_accel(tris: TrianglesSoA, cam, *, iterations: int = 5,
                     gs: int = 128, threshold: float = 0.55,
                     fallback: str = "minarg") -> str:
    """'tilecull' when `estimate_tile_need_fraction` is below threshold,
    else `fallback`, for a scene of gs + 1 to gs * MAX_GROUPS triangles
    (`fallback` outside that range, without sampling). The default
    threshold is the JAX package's, set on a TPU; the engine passes the
    H100's (`runtime/engine.py::AUTO_TILECULL_THRESHOLD`)."""
    if tris.count <= gs or tris.count > gs * MAX_GROUPS:
        return fallback
    frac = estimate_tile_need_fraction(tris, cam, gs=gs,
                                       iterations=iterations)
    return "tilecull" if frac < threshold else fallback
