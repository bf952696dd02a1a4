"""K1: nearest triangle hit, min + argmin, K4: the dense nearest hit
with the winner's index and attributes, and K15: K4's outputs with the
dots as one matmul (CUDA kernels and plain versions).

Port of `opencl_path_tracer_tpu/ops/pallas/intersect_kernel.py`:
`_minarg_kernel` (launched by `_run_minarg`), `_kernel` (launched by
`_run`) with `pallas_first_intersect`, `make_pallas_intersect` and
`assemble_hits`, `_mxu_kernel` (launched by `_run_mxu`) with
`make_mxu_intersect`, and the ray and triangle packs they read
(`pack_rays`, `build_tri_pack`).

For each ray, over all triangles: t = (c0 - dot(P, n)) / dot(D, n),
accepted when t > 0 and dot(P, m_k) + t dot(D, m_k) >= d_k for the three
edges (prog.cl:94-112 in the m_k form of `core/geometry.py`). Outputs
the least accepted t (BIG on a miss) and the lowest index that reaches
it, as float32 (exact up to 2^24 triangles).

The reference values come from the Pallas kernel run in interpret mode
on the CPU, where XLA fuses each dot product's first two terms and each
edge test's `t * vm + pm` into fused multiply-adds; the plain version
does the same with `core.fp.fma`, and the CUDA kernel
(`csrc/minarg.cu`) with `__fmaf_rn`. K15 rounds its own way (see its
section below).
"""

from __future__ import annotations

import torch

from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.types import Hits, Rays
from opencl_path_tracer_tpu_torch.ops.kernels import _build

BIG = 3.0e38
TRI_COLS = 24
_PLAIN_RAYS = 8192        # rays per chunk of minarg_plain
_PLAIN_CELLS = 1 << 22    # (ray, triangle) tests per chunk of minarg_plain
_KERNEL_BLOCK = 256       # rays per block of the CUDA kernels (kBlock)
_KERNEL_TILE = 256        # triangles per shared-memory tile (kTile)
_SPLIT_BLOCKS_PER_SM = 32  # K4 splits its triangles up to this many blocks
SUB = 32   # rows per sub-block of the skip rule (csrc/sub_cull.cuh's kSub)
# K15's warp tests a sub-block for at most this many of its rays together,
# all 32 lanes on one ray's rows (csrc/mxu.cu); for more, each lane tests
# its own ray. 12, 16 and 24 measured within 0.6 % on the Cornell camera
# and first-bounce rays, 4 up to 12 % slower and 32 1.2-1.5x
# (runtime/cull_ab.py --coop; PERF.md).
MXU_COOP = 16


def pack_rays(p, d, pad_to: int | None = None) -> torch.Tensor:
    """(8, R) float32 rows [px py pz dx dy dz 0 0]; with pad_to, (8,
    pad_to) with zero rays past R."""
    z = torch.zeros_like(p[0])
    rows = torch.stack([p[0], p[1], p[2], d[0], d[1], d[2], z, z])
    if pad_to is None or pad_to == rows.shape[1]:
        return rows
    return torch.cat([rows, rows.new_zeros((8, pad_to - rows.shape[1]))], 1)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def build_tri_pack(tris: TrianglesSoA, tt: int | None = None) -> torch.Tensor:
    """(T, 24) float32 rows [n c0 m1 d1 m2 d2 m3 d3 mati 0*7]. Given `tt`,
    zero rows (never hit: n = 0) pad it as the JAX package's
    `build_tri_pack(tris, tt)` does: to a multiple of 8 up to tt
    triangles, else to a multiple of tt."""
    t = tris.count
    pad = 0
    if tt is not None:
        pad = (_round_up(t, 8) if t <= tt else _round_up(t, tt)) - t
    return torch.cat([
        torch.cat([
            tris.n, tris.c0[:, None], tris.m1, tris.d1[:, None],
            tris.m2, tris.d2[:, None], tris.m3, tris.d3[:, None],
            tris.mati.to(torch.float32)[:, None],
            torch.zeros((t, 7), dtype=torch.float32, device=tris.device),
        ], dim=1),
        torch.zeros((pad, TRI_COLS), dtype=torch.float32, device=tris.device),
    ]).contiguous()


def _dot3(v, a):
    """dot(v, a) with XLA's contraction: fma(v2, a2, fma(v0, a0, v1 a1))."""
    return fp.fma(v[2], a[2], fp.fma(v[0], a[0], v[1] * a[1]))


def exact_test(rows: torch.Tensor, rays: torch.Tensor):
    """K1's exact test of the rays of an (8, R) pack against the rows of a
    (T, 24) pack: (t, valid), two (T, R) tensors. Leading batch
    dimensions, (..., 8, R) and (..., T, 24), broadcast."""
    c = rows[..., :16, None]                       # (..., T, 16, 1)
    p = (rays[..., 0:1, :], rays[..., 1:2, :], rays[..., 2:3, :])
    d = (rays[..., 3:4, :], rays[..., 4:5, :], rays[..., 5:6, :])

    def col(j):
        return c[..., j, :]                        # (..., T, 1)

    def dots(base):
        v = (col(base), col(base + 1), col(base + 2))
        return _dot3(v, p), _dot3(v, d)

    pn, vn = dots(0)
    t = (col(3) - pn) / vn
    valid = t > 0.0
    for base in (4, 8, 12):
        pm, vm = dots(base)
        valid &= fp.fma(t, vm, pm) >= col(base + 3)
    return t, valid


def minarg_plain(rays8: torch.Tensor, tri_pack: torch.Tensor):
    """Plain PyTorch version of K1: (t, g), two (R,) float32 tensors.
    Rays and triangles go in chunks of at most _PLAIN_CELLS (ray,
    triangle) tests; a later triangle chunk wins only with a strictly
    smaller t, so ties keep the lowest index. A ray with D = 0 (the zero
    rays that pad a batch) meets every plane at t = inf or NaN, whose
    edge tests fail: it is a miss, (BIG, 0), without being tested."""
    r = rays8.shape[1]
    n_tris = tri_pack.shape[0]
    t_out = torch.full((r,), BIG, dtype=torch.float32, device=rays8.device)
    g_out = torch.zeros(r, dtype=torch.float32, device=rays8.device)
    live = torch.nonzero((rays8[3:6] != 0.0).any(0)).flatten()
    for s in range(0, live.numel(), _PLAIN_RAYS):
        cols = live[s:s + _PLAIN_RAYS]
        rays = rays8[:, cols]
        step = max(1, _PLAIN_CELLS // rays.shape[1])
        best = best_g = None
        for b in range(0, n_tris, step):
            t, valid = exact_test(tri_pack[b:b + step], rays)
            tm = torch.where(valid, t, torch.full_like(t, BIG))
            m, a = torch.min(tm, dim=0)            # first index on ties
            a = a + b
            if best is None:
                best, best_g = m, a
            else:
                bet = m < best
                best = torch.where(bet, m, best)
                best_g = torch.where(bet, a, best_g)
        t_out[cols] = best
        g_out[cols] = best_g.to(torch.float32)
    return t_out, g_out


def _check_minarg(rays8: torch.Tensor, tri_pack: torch.Tensor,
                  entry: str) -> None:
    _build.check(rays8, "rays8", (8, None))
    _build.check(tri_pack, "tri_pack", (None, TRI_COLS))
    if rays8.device != tri_pack.device:
        raise ValueError("rays8 and tri_pack must be on one device")
    if not 0 < tri_pack.shape[0] < 1 << 24:
        raise ValueError(f"{entry} needs 1 to 2^24 - 1 triangles (the "
                         "winner index travels as an exact float32)")


def _launch_minarg(entry: str, rays8: torch.Tensor, tri_pack: torch.Tensor,
                   *extra):
    r = rays8.shape[1]
    t = torch.empty(r, dtype=torch.float32, device=rays8.device)
    g = torch.empty(r, dtype=torch.float32, device=rays8.device)
    _build.launch(entry, rays8, tri_pack, t, g, r, tri_pack.shape[0], *extra)
    return t, g


def minarg(rays8: torch.Tensor, tri_pack: torch.Tensor):
    """K1: (t, g) for each ray of the (8, R) pack against the (T, 24)
    triangle pack. CPU tensors take the plain version; CUDA tensors
    launch the kernel (`csrc/minarg.cu`, which settles the pairs it can
    by sign or distance before the divide where a warp's rays are
    coherent enough to skip it together) or raise."""
    _check_minarg(rays8, tri_pack, "minarg")
    if rays8.device.type == "cpu":
        return minarg_plain(rays8, tri_pack)
    return _launch_minarg("minarg", rays8, tri_pack)


def minarg_simt(rays8: torch.Tensor, tri_pack: torch.Tensor):
    """K1's first kernel (`csrc/minarg.cu::minarg_simt_kernel`, nearest.cuh's
    loop: every pair divided), on CUDA tensors: minarg's (t, g). For the
    checks only (the smoke and the cuda tests hold the kernel against it
    and time the two in turns); no render path calls it."""
    _check_minarg(rays8, tri_pack, "minarg_simt")
    if rays8.device.type != "cuda":
        raise ValueError("minarg_simt runs on CUDA tensors only")
    return _launch_minarg("minarg_simt", rays8, tri_pack)


def minarg_counted(rays8: torch.Tensor, tri_pack: torch.Tensor):
    """minarg's kernel on CUDA tensors, also counting the (ray, triangle)
    pairs that reached the divide, those that reached the edge tests, and
    the warps that ran the tiles after the first through the joint loop
    (their rays seldom skip the divide together; 0 for one tile):
    ((t, g), divides, edge pairs, joint warps). For the checks only; no
    render path calls it."""
    _check_minarg(rays8, tri_pack, "minarg_counted")
    if rays8.device.type != "cuda":
        raise ValueError("minarg_counted runs on CUDA tensors only")
    count = torch.zeros(3, dtype=torch.int64, device=rays8.device)
    out = _launch_minarg("minarg_count", rays8, tri_pack, count)
    divides, edges, joint = count.tolist()
    return out, divides, edges, joint


def dense_plain(rays8: torch.Tensor, tri_pack: torch.Tensor,
                out: torch.Tensor | None = None):
    """Plain PyTorch version of K4: (t, index, nx, ny, nz, mati), six (R,)
    float32 tensors. t is BIG on a miss, and a miss keeps index 0 with
    row 0's attributes (the TPU kernel's latch); attributes are `+ 0.0`,
    as the TPU's one-hot sum turns -0.0 into +0.0. Given `out`, writes
    the hit rows [t (-1 on a miss), nx, ny, nz, mati, 0] there instead
    and returns it."""
    t, g = minarg_plain(rays8, tri_pack)
    rows = tri_pack[g.long()]
    attrs = (rows[:, 0] + 0.0, rows[:, 1] + 0.0, rows[:, 2] + 0.0,
             rows[:, 16] + 0.0)
    if out is None:
        return (t, g) + attrs
    out[0] = torch.where(t < BIG, t, torch.full_like(t, -1.0))
    out[1:5] = torch.stack(attrs)
    out[5] = 0.0
    return out


def dense_splits(n_rays: int, n_tris: int, sms: int) -> tuple[int, int]:
    """(splits, chunk): how K4 cuts the triangles across blocks. One
    thread per ray gives ceil(n_rays / 256) blocks; below
    _SPLIT_BLOCKS_PER_SM blocks per SM the triangles go in `splits`
    chunks of `chunk` (a whole number of 256-triangle tiles), one grid
    row of ray blocks each, so that the grid reaches that count or each
    chunk is one tile. (1, n_tris) is the single-loop kernel, which the
    2M-ray camera batches take; the stress tails' 16,384 lanes take 65
    chunks of 1,536 and the fused pipeline's exact slice (76,800 lanes,
    804 triangles) 4 of 256."""
    blocks = -(-n_rays // _KERNEL_BLOCK)
    tiles = -(-n_tris // _KERNEL_TILE)
    want = -(-_SPLIT_BLOCKS_PER_SM * sms // max(blocks, 1))
    splits = max(1, min(want, tiles))
    if splits == 1:
        return 1, n_tris
    chunk_tiles = -(-tiles // splits)
    return -(-tiles // chunk_tiles), chunk_tiles * _KERNEL_TILE


def dense(rays8: torch.Tensor, tri_pack: torch.Tensor,
          out: torch.Tensor | None = None):
    """K4 for each ray of the (8, R) pack against the (T, 24) triangle
    pack: (t, index, nx, ny, nz, mati), six (R,) float32 tensors. Given
    `out`, a (6, R) float32 tensor, it writes the fused pipeline's hit rows
    [t (-1 on a miss), nx, ny, nz, mati, 0] there instead and returns it.
    The rows of rays8 and of out need only be contiguous each, so column
    slices of wider tensors are read and written in place. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise (with
    few rays, over triangle chunks and a combine: `dense_splits`)."""
    _build.check_rows(rays8, "rays8", 8)
    _build.check(tri_pack, "tri_pack", (None, TRI_COLS))
    r = rays8.shape[1]
    if out is not None:
        _build.check_rows(out, "out", 6)
        if out.shape[1] != r:
            raise ValueError(f"out has {out.shape[1]} columns, rays8 {r}")
    if not all(x.device == rays8.device for x in (tri_pack, out)
               if x is not None):
        raise ValueError("rays8, tri_pack and out must be on one device")
    if not 0 < tri_pack.shape[0] < 1 << 24:
        raise ValueError("dense needs 1 to 2^24 - 1 triangles (the winner "
                         "index travels as an exact float32)")
    if rays8.device.type == "cpu":
        return dense_plain(rays8, tri_pack, out)
    rows = out if out is not None else torch.empty(
        (6, r), dtype=torch.float32, device=rays8.device)
    n_tris = tri_pack.shape[0]
    splits, chunk = dense_splits(r, n_tris, torch.cuda.get_device_properties(
        rays8.device).multi_processor_count)
    # The chunks' (t, index) pairs: splits x r floats, then splits x r ints.
    work = (torch.empty(2 * splits * r, dtype=torch.float32,
                        device=rays8.device) if splits > 1 else 0)
    _build.launch("dense", rays8, rays8.stride(0), tri_pack, rows,
                  rows.stride(0), int(out is not None), r, n_tris, splits,
                  chunk, work)
    return out if out is not None else tuple(rows)


def assemble_hits(rays: Rays, r: int, t_, nx, ny, nz, m) -> Hits:
    """Hits from (R,) kernel rows with t = -1 on a miss: the normal rows
    pass through (miss-lane normals are whatever the kernel latched),
    mati is 0 on a miss."""
    best_t = t_[:r]
    any_hit = best_t > 0.0
    z = torch.zeros_like(best_t)
    safe_t = torch.where(any_hit, best_t, z)
    return Hits(
        t=best_t,
        p=tuple(torch.where(any_hit, rays.p[k] + rays.d[k] * safe_t, z)
                for k in range(3)),
        n=(nx[:r], ny[:r], nz[:r]),
        mati=torch.where(any_hit, m[:r], z).to(torch.int32),
    )


def first_intersect(rays: Rays, tris: TrianglesSoA, *,
                    tri_pack: torch.Tensor | None = None) -> Hits:
    """Closest hit of each ray through K4 (`pallas_first_intersect`)."""
    if tri_pack is None:
        tri_pack = build_tri_pack(tris)
    t, _, nx, ny, nz, m = dense(pack_rays(rays.p, rays.d), tri_pack)
    t = torch.where(t < BIG, t, torch.full_like(t, -1.0))
    return assemble_hits(rays, rays.count, t, nx, ny, nz, m)


def make_pallas_intersect(tris: TrianglesSoA):
    """The 'pallas' accel: K4 over a pack built once; intersect(rays) ->
    Hits."""
    tri_pack = build_tri_pack(tris)

    def intersect(rays: Rays) -> Hits:
        return first_intersect(rays, tris, tri_pack=tri_pack)

    return intersect


# --- K15: the dense intersect with its eight dots as one matmul ----------
#
# On the TPU `_mxu_kernel` computes the eight dots [pn vn pm1 vm1 pm2 vm2
# pm3 vm3] of each (triangle, ray) as one (8 TT, 8) x (8, TR) float32
# matmul at Precision.HIGHEST over a tiled copy of the triangle constants,
# then K4's plane and edge tests, argmin per tile of TT triangles (first
# index), strict < across tiles and one-hot float32 sums for the winner's
# attributes. The result is the lexicographic (t, index) minimum whatever
# the tiling, so the port reads K4's (T, 24) pack. In interpret mode XLA's
# CPU matmul sums each dot as one chain of fused multiply-adds in k order,
# fma(v2, a2, fma(v1, a1, v0 * a0)), then adds the five zero columns of
# the row (exact zeros: only a -0.0 dot turns +0.0); the edge tests come
# out as fma(t, vm, pm). This is not K4's rounding (`_dot3`), so K15 has
# a test of its own here and in `csrc/mxu.cu`.


def _mxu_dot(v, a):
    """One dot of the matmul: fma(v2, a2, fma(v1, a1, v0 a0)) + 0.0."""
    return fp.fma(v[:, 2:3], a[2], fp.fma(v[:, 1:2], a[1],
                                          v[:, 0:1] * a[0])) + 0.0


def mxu_exact_test(rows: torch.Tensor, rays: torch.Tensor):
    """K15's exact test of the rays of an (8, R) pack against the rows of a
    (T, 24) pack: (t, valid), two (T, R) tensors, with the matmul's dots
    (`_mxu_dot`) and edge tests fma(t, vm, pm)."""
    p, d = rays[0:3], rays[3:6]
    n = rows[:, 0:3]
    t = (rows[:, 3:4] - _mxu_dot(n, p)) / _mxu_dot(n, d)
    valid = t > 0.0
    for e in range(4, 16, 4):
        m = rows[:, e:e + 3]
        valid &= (fp.fma(t, _mxu_dot(m, d), _mxu_dot(m, p))
                  >= rows[:, e + 3:e + 4])
    return t, valid


def mxu_plain(rays8: torch.Tensor, tri_pack: torch.Tensor):
    """Plain PyTorch version of K15: (t, index, nx, ny, nz, mati), six
    (R,) float32 tensors. t is BIG on a miss; the winner is the least t
    with the lowest index (per-tile argmin and strict < across tiles give
    the same); a miss keeps index 0 with triangle 0's attributes (tile
    0's latch), and the attributes are `+ 0.0` (the one-hot sum turns
    -0.0 into +0.0). Rays with D = 0 (padding) never hit and are not
    tested."""
    r = rays8.shape[1]
    n_tris = tri_pack.shape[0]
    t_out = torch.full((r,), BIG, dtype=torch.float32, device=rays8.device)
    g_out = torch.zeros(r, dtype=torch.int64, device=rays8.device)
    live = torch.nonzero((rays8[3:6] != 0.0).any(0)).flatten()
    for s in range(0, live.numel(), _PLAIN_RAYS):
        cols = live[s:s + _PLAIN_RAYS]
        x = rays8[:, cols]
        step = max(1, _PLAIN_CELLS // x.shape[1])
        best = best_g = None
        for b in range(0, n_tris, step):
            t, valid = mxu_exact_test(tri_pack[b:b + step], x)
            tm, a = torch.min(torch.where(valid, t, torch.full_like(t, BIG)),
                              dim=0)                     # first on ties
            a = a + b
            if best is None:
                best, best_g = tm, a
            else:
                bet = tm < best
                best = torch.where(bet, tm, best)
                best_g = torch.where(bet, a, best_g)
        t_out[cols] = best
        g_out[cols] = best_g
    attrs = tri_pack[g_out][:, [0, 1, 2, 16]] + 0.0
    return (t_out, g_out.to(torch.float32), attrs[:, 0], attrs[:, 1],
            attrs[:, 2], attrs[:, 3])


def check_dense(rays8: torch.Tensor, tri_pack: torch.Tensor,
                sub: torch.Tensor | None, what: str) -> int:
    """K14's and K15's checks: K1's, and, given, the table, which must be
    able to be `cluster_kernel.sub_boxes(tri_pack, [(0, T)])`: (ceil(T /
    SUB), 8) float32 on the pack's device (its values are not read back
    from the card). Returns R."""
    _check_minarg(rays8, tri_pack, what)
    if sub is not None:
        _build.check(sub, "sub", (None, 8))
        if sub.device != tri_pack.device:
            raise ValueError(f"{what}'s sub must be on the pack's device")
        t = tri_pack.shape[0]
        if sub.shape[0] != -(-t // SUB):
            raise ValueError(f"{what}'s sub has {sub.shape[0]} rows: the "
                             f"sub_boxes table of {t} rows in one span has "
                             f"{-(-t // SUB)}")
    return rays8.shape[1]


def mxu(rays8: torch.Tensor, tri_pack: torch.Tensor,
        sub: torch.Tensor | None = None):
    """K15 for each ray of the (8, R) pack against the (T, 24) triangle
    pack: (t, index, nx, ny, nz, mati), six (R,) float32 tensors (t BIG
    on a miss). sub: the pack's table of the skip rule,
    `cluster_kernel.sub_boxes(tri_pack, [(0, T)])`, which the kernel needs
    (`make_mxu_intersect` builds it once per scene; the plain version
    ignores it). CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    r = check_dense(rays8, tri_pack, sub, "mxu")
    if rays8.device.type == "cpu":
        return mxu_plain(rays8, tri_pack)
    if sub is None:
        raise ValueError("mxu on CUDA tensors needs sub, the pack's "
                         "sub_boxes table")
    rows = torch.empty((6, r), dtype=torch.float32, device=rays8.device)
    _build.launch("mxu", rays8, tri_pack, sub, rows, r, tri_pack.shape[0],
                  MXU_COOP)
    return tuple(rows)


def mxu_simt(rays8: torch.Tensor, tri_pack: torch.Tensor):
    """K15's first kernel (`csrc/mxu.cu::mxu_simt_kernel`: every row
    staged for the block, every (ray, triangle) test run), on CUDA
    tensors: mxu's outputs. For the checks only (the smoke and the cuda
    tests hold the new kernel against it and time the two in turns); no
    render path calls it."""
    r = check_dense(rays8, tri_pack, None, "mxu_simt")
    if rays8.device.type != "cuda":
        raise ValueError("mxu_simt runs on CUDA tensors only")
    rows = torch.empty((6, r), dtype=torch.float32, device=rays8.device)
    _build.launch("mxu_simt", rays8, tri_pack, rows, r, tri_pack.shape[0])
    return tuple(rows)


def mxu_counted(rays8: torch.Tensor, tri_pack: torch.Tensor,
                sub: torch.Tensor):
    """mxu's kernel on CUDA tensors, also counting: (outputs, (tests that
    reached the divide, (ray, sub-block) box tests that passed, those of
    them run by the whole warp, edge tests reached, box tests made)). For
    the checks only; no render path calls it."""
    r = check_dense(rays8, tri_pack, sub, "mxu_counted")
    if rays8.device.type != "cuda":
        raise ValueError("mxu_counted runs on CUDA tensors only")
    rows = torch.empty((6, r), dtype=torch.float32, device=rays8.device)
    count = torch.zeros(5, dtype=torch.int64, device=rays8.device)
    _build.launch("mxu_count", rays8, tri_pack, sub, rows, r,
                  tri_pack.shape[0], MXU_COOP, count)
    return tuple(rows), tuple(int(x) for x in count.tolist())


def make_mxu_intersect(tris: TrianglesSoA):
    """K15 over `build_tri_pack(tris)`, built once (the JAX package's
    `make_mxu_intersect`; its `tr`, `tt` and `interpret` are TPU tiling
    and have no counterpart), with, on the card, the pack's table of the
    skip rule (`cluster_kernel.sub_boxes` over the one span [0, T)), also
    built once. intersect(rays) -> Hits: t = -1 on a miss, the normals as
    the kernel returns them (a miss carries triangle 0's), mati 0 on a
    miss."""
    # Imported here: cluster_kernel imports this module.
    from opencl_path_tracer_tpu_torch.ops.kernels.cluster_kernel import (
        sub_boxes)
    tri_pack = build_tri_pack(tris)
    sub = (sub_boxes(tri_pack, [(0, tri_pack.shape[0])])
           if tri_pack.device.type == "cuda" else None)

    def intersect(rays: Rays) -> Hits:
        t, _, nx, ny, nz, m = mxu(pack_rays(rays.p, rays.d), tri_pack, sub)
        t = torch.where(t < BIG, t, torch.full_like(t, -1.0))
        return assemble_hits(rays, rays.count, t, nx, ny, nz, m)

    return intersect
