"""The sort-grouped intersectors: K16 (`accel='group'`), K12 and the
pair-expansion intersector for large scenes (`accel='pair'` and
`'pairwin'`), and K9, the per-ray cluster candidates.

Port of `opencl_path_tracer_tpu/ops/pallas/sorted_intersect.py`:
`_perray_slab`, `_hits_from_raw`, `_group_kernel` (launched by
`_run_group`) and `make_group_intersect` (:63-256); `_pair_kernel`
(launched by `_run_pairs`, :312-416); `_cand_kernel` (launched by
`_run_candidates`, :419-523); `_auto_cluster_size`, `split_by_size`,
`_pairs_round`, `_merge_best` and `PAIR_TPU_WINNER` (:526-662); and
`make_pair_intersect` (:665-1653) with every option: the VPU pairs round
(mxu=False, the function's defaults and the 'pair' accel: K12 on
`cluster_kernel.build_clusters`' packs, the full (t, nx, ny, nz, mati)
best); the MXU pairs round K10 on the march packs with the full payload
(mxu=True, thin=False: the 'pairmx' accel at trp 512, K10's five
streams) or the thin (t, triangle id) payload with K11 at the end (the
TPU's production configuration `PAIR_TPU_WINNER`, the 'pairwin' accel,
with or without ids); DOP boxes; the in-kernel features (`infeat`); the
round-1-only `approx`; and `move='gather'`, `'sort'` or `'chain'`.

K16 (`run_group`, `make_group_intersect`, scenes of at most 30
clusters of `build_clusters(split_large=True)`): each ray's bitmask of
the clusters whose box its slab test passes; the rays sorted by mask
(stably); every block of `block` sorted rays tests every cluster of the
union of its masks, in ascending cluster order. On the card a ray skips
the sub-blocks of `SUB` rows whose boxes (`cluster_sub_boxes`, built
once per scene) its segment to the running best misses
(`csrc/group.cu`).

K12 (`run_pairs`): per (ray, cluster) pair, sorted by cluster key, the
nearest hit among that cluster's K triangles with its normal and
material (`cluster_kernel.cluster_nearest`); the dummy key C is no work
and leaves (BIG, 0, 0, 0, 0). The TPU's tile of `trp` pairs only pads
the list: a pair's result does not depend on it. On the card a pair
skips the sub-blocks of `SUB` rows whose boxes (`pair_sub_boxes`, built
once per scene) its segment to the running best misses; the rule and
its proof are in `csrc/pair_vpu.cu`.

The schedule is the JAX package's, lane for lane: the scene-spanning
triangles seed every ray's best t (K4, or K1 + K2 with ids); round 1
tests every ray against its l1 nearest passing clusters (K9, then K12
or K10) and certifies a ray when its best t is at most the entry
distance of its first untested candidate and no pair of it ended
pending (K10 only); the escalations take the first u unresolved rays in
slot order and test each one's next w ranks; a dense tail (K4, or K1
with ids) certifies the rest `tail` rays at a time; with the thin
payload K11 fetches the winners' attributes once at the end.
`move='sort'` takes the first u rays in (resolved, slot) order, a 2-key
sort; `move='gather'` sorts (resolved, slot) with one key, whose order
within a flag the JAX package leaves unspecified: its CPU `lax.sort` is
stable (ROADMAP.md queue 3), which gives the same slot order, so one
body serves both. Capacities, windows and selection depths are
identical, so `resolved`, `done` and `pend` follow the JAX package's.
The TPU moved data by sorting because its gathers are slow; the port
gathers and scatters (`argsort`, `index_select`, indexed assignment)
where the JAX package sorts data along, and sorts only where a sort
decides which work is done.

`move='chain'` (thin only, :868-891, :1254-1415): after round 1 one
sort moves every ray into chain space, unresolved first, then by slot
(the TPU folds slot, progress and pend into one key, slot * 128 + done *
2 + pend, whose order is the slot's); the escalations update their
prefix in place, and only the live region is sorted again between
tiers, by (resolved, slot); a dense tail over the region [0, u2)
(chunks of min(tail, u2) rays, the last chunk's start clamped to the end
of the arrays as `dynamic_slice` clamps it) runs K1 over the
march-ordered triangles (`build_tri_pack(rt, 1024)`, scene-spanning
triangles left out: they seeded the best), so its winner is the
cluster-ordered id that K11 decodes; one scatter by slot goes back, and
the full-width tail certifies what overflowed the region. K1 breaks
exact-t ties by the lowest march-ordered row, not by the original
index, so the chain's hits follow JAX's chain, not 'pairwin'. `approx`
returns (Hits, resolved) after round 1: from K11 and the overlay with
the thin payload, from the full payload otherwise; only the resolved
lanes are proven nearest.
"""

from __future__ import annotations

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.types import Hits, Rays
from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.ops.kernels.cluster_kernel import (
    _PLAIN_CELLS, SUB, _xmax, _xmin, build_clusters, cluster_nearest,
    cluster_sub_boxes, pack_rays_rows, winner_attrs,
)
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    BIG, TRI_COLS, _round_up, build_tri_pack, make_pallas_intersect, minarg,
    pack_rays,
)
from opencl_path_tracer_tpu_torch.ops.kernels.march_kernel import (
    _slab_axis, build_march_scene,
)
from opencl_path_tracer_tpu_torch.ops.kernels import pair_mxu
from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
    make_minarg_intersect,
)

MAX_RANKS = 48   # the deepest K9 selection csrc/pair_cand.cu keeps (l <= 48)
_PLAIN_RAYS = 8192   # rays per chunk of candidates_plain

# Set to a list to make every pair-intersector call append a dict of its
# schedule's counts (rays, round 1's resolved rays, each escalation's
# (capacity, window, unresolved rays taken), with move='chain' the chain
# tail's rays and iterations, the full-width tail's rays and iterations,
# pending rays; with approx only the first two); None (the default)
# records nothing.
STATS = None

# The TPU's production configuration for large scenes, the 'pairwin'
# accel (the JAX package's round-3 on-device sweeps; its numbers are the
# TPU's, not the port's).
PAIR_TPU_WINNER = dict(mxu=True, dop=True, cluster_size=256, trp=1024,
                       l1=2, l2=6, thin=True, move="sort")
MAX_GROUP_CLUSTERS = 30   # K16's bitmask (a uint32 in the JAX package)


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


def _perray_slab(comps, boxes: torch.Tensor) -> torch.Tensor:
    """(R, C) bool: each ray's slab test against every (C, 8) cluster box
    [lo3 hi3 _ _] (K9's test, d == 0 testing containment)."""
    r, c = comps[0].shape[0], boxes.shape[0]
    dev = comps[0].device
    tmin = torch.full((r, c), -BIG, device=dev)
    tmax = torch.full((r, c), BIG, device=dev)
    for ax in range(3):
        tmin, tmax = _slab_axis(tmin, tmax, boxes[None, :, ax],
                                boxes[None, :, ax + 3], comps[ax][:, None],
                                comps[3 + ax][:, None])
    return (tmax >= tmin) & (tmax >= 0.0)


def _cluster_count(rows: torch.Tensor, k: int, what: str) -> int:
    _build.check(rows, what, (None, TRI_COLS))
    c = rows.shape[0] // k if k > 0 else 0
    if c == 0 or rows.shape[0] != c * k:
        raise ValueError(f"{what} ({rows.shape[0]} rows) must be whole "
                         f"clusters of k = {k}")
    return c


def group_plain(union: torch.Tensor, rays8: torch.Tensor, rows: torch.Tensor,
                k: int, block: int) -> torch.Tensor:
    """Plain PyTorch version of K16: (5, Rpad) float32 rows [t (BIG on a
    miss), nx, ny, nz, mati] for the (Rpad, 8) rays, each tested against
    every cluster of its block's union, in ascending cluster order. A ray
    with D = 0 (the zero rays that pad a batch) misses every triangle
    (see `minarg_plain`) and is not tested."""
    rpad = rays8.shape[0]
    c = rows.shape[0] // k
    ray_union = torch.where((rays8[:, 3:6] != 0.0).any(1),
                            union.long().repeat_interleave(block), 0)
    rays_t = rays8.t()
    best_t = torch.full((rpad,), BIG, device=rays8.device)
    best_g = torch.zeros(rpad, dtype=torch.int64, device=rays8.device)
    chunk = max(1, _PLAIN_CELLS // k)
    for ci in range(c):
        sel = torch.nonzero((ray_union >> ci) & 1).flatten()
        for s in range(0, sel.numel(), chunk):
            idx = sel[s:s + chunk]
            tm, local = cluster_nearest(rows[ci * k:(ci + 1) * k],
                                        rays_t[:, idx])
            better = tm < best_t[idx]
            best_t[idx] = torch.where(better, tm, best_t[idx])
            best_g[idx] = torch.where(better, ci * k + local, best_g[idx])
    return torch.stack([best_t, *winner_attrs(rows, best_g, best_t < BIG)])


# K16's warp tests a sub-block for at most this many of its rays
# together, all 32 lanes on one ray's rows (csrc/group.cu); for more, each
# lane tests its own ray. On the reference camera and first-bounce rays
# 16 and 24 measured within 1 % and 2.5 % of each other, 12 and 8 up to
# 7 % and 9 % slower than 16, 32 up to 1.7x (runtime/cull_ab.py --coop;
# PERF.md).
GROUP_COOP = 16


def _check_group(union, rays8, rows, k, block, what):
    _build.check(rays8, "rays8", (None, 8))
    rpad = rays8.shape[0]
    if block <= 0 or rpad % block:
        raise ValueError(f"{what} needs Rpad ({rpad}) a multiple of block "
                         f"({block})")
    c = _cluster_count(rows, k, "rows")
    if c > MAX_GROUP_CLUSTERS:
        raise ValueError(f"{c} clusters exceed K16's {MAX_GROUP_CLUSTERS}"
                         "-bit mask")
    _build.check(union, "union", (rpad // block,), torch.int32)
    if union.device != rays8.device or rows.device != rays8.device:
        raise ValueError(f"{what}'s tensors must be on one device")
    return c


def run_group(union: torch.Tensor, rays8: torch.Tensor, rows: torch.Tensor,
              k: int, block: int, sub: torch.Tensor | None = None):
    """K16: (t, nx, ny, nz, mati), five (Rpad,) float32 tensors, for the
    (Rpad, 8) mask-sorted ray rows, Rpad a multiple of block, against the
    (C K, 24) cluster rows, C <= 30: union (G,) int32 holds each block's
    cluster bits. sub: the rows' `cluster_sub_boxes` table, which the
    kernel needs (`make_group_intersect` builds it once per scene; the
    plain version ignores it). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    c = _check_group(union, rays8, rows, k, block, "run_group")
    rpad = rays8.shape[0]
    if rays8.device.type == "cpu":
        return tuple(group_plain(union, rays8, rows, k, block))
    if sub is None:
        raise ValueError("run_group on CUDA tensors needs sub, the rows' "
                         "cluster_sub_boxes table")
    _check_sub(sub, rows, k)
    out = torch.empty((5, rpad), dtype=torch.float32, device=rays8.device)
    if rpad:
        _build.launch("group", union, rays8, rows, sub, out, rpad, block, c,
                      k, GROUP_COOP)
    return tuple(out)


def run_group_simt(union: torch.Tensor, rays8: torch.Tensor,
                   rows: torch.Tensor, k: int, block: int):
    """K16's first kernel (`csrc/group.cu::group_simt_kernel`: each
    cluster of the union staged for the block where any of its rays takes
    it), on CUDA tensors: run_group's rows. For the checks only (the smoke
    and the cuda tests hold the new kernel against it on whole launches
    and time the two in turns); no render path calls it."""
    c = _check_group(union, rays8, rows, k, block, "run_group_simt")
    if rays8.device.type != "cuda":
        raise ValueError("run_group_simt runs on CUDA tensors only")
    rpad = rays8.shape[0]
    out = torch.empty((5, rpad), dtype=torch.float32, device=rays8.device)
    if rpad:
        _build.launch("group_simt", union, rays8, rows, out, rpad, block, c,
                      k)
    return tuple(out)


def run_group_counted(union: torch.Tensor, rays8: torch.Tensor,
                      rows: torch.Tensor, k: int, block: int,
                      sub: torch.Tensor):
    """run_group's kernel on CUDA tensors, also counting: (rows, (tests
    that reached the divide, (ray, sub-block) box tests that passed,
    those of them run by the whole warp, edge tests reached, box tests
    made)). For the checks only; no render path calls it."""
    c = _check_group(union, rays8, rows, k, block, "run_group_counted")
    _check_sub(sub, rows, k)
    if rays8.device.type != "cuda":
        raise ValueError("run_group_counted runs on CUDA tensors only")
    rpad = rays8.shape[0]
    out = torch.empty((5, rpad), dtype=torch.float32, device=rays8.device)
    count = torch.zeros(5, dtype=torch.int64, device=rays8.device)
    if rpad:
        _build.launch("group_count", union, rays8, rows, sub, out, rpad,
                      block, c, k, GROUP_COOP, count)
    return tuple(out), tuple(int(x) for x in count.tolist())


def make_group_intersect(tris: TrianglesSoA, *, cluster_size: int = 128,
                         block: int = 2048, tr: int | None = None,
                         subtiles: int | None = None):
    """The 'group' accel, for scenes of at most 30 clusters of
    `build_clusters(split_large=True)`; intersect(rays) -> Hits. Per call:
    each ray's cluster bitmask (`_perray_slab`), a stable sort by mask,
    each block's union, K16, the results back in ray order. tr and
    subtiles are accepted as in the JAX package: block = tr * subtiles.
    On the card, K16's table of the skip rule (`cluster_sub_boxes`) is
    built once here."""
    if tr is not None:
        block = tr * (subtiles or 1)
    scene, c, k = build_clusters(tris, cluster_size, split_large=True)
    if c > MAX_GROUP_CLUSTERS:
        raise ValueError(f"{c} clusters exceed the u32 mask (use the pair "
                         "intersector)")
    rows = scene.rows()
    sub = cluster_sub_boxes(rows, k) if rows.device.type == "cuda" else None

    def intersect(rays: Rays) -> Hits:
        order, union, rays8 = group_inputs(rays, scene.boxes, block)
        outs = run_group(union, rays8, rows, k, block, sub)
        back = [torch.empty_like(o).index_copy_(0, order, o) for o in outs]
        return _hits_from_raw(rays, back[0], back[1:4], back[4], rays.count)

    return intersect


def group_inputs(rays: Rays, boxes: torch.Tensor, block: int):
    """K16's inputs for the rays, padded with zero rays to a multiple of
    block: (order, the mask-sorted position -> ray; union (G,) int32,
    each block's cluster bits; rays8 (Rpad, 8), the rays in mask order).
    A ray's mask has bit c set when its slab test passes cluster c's box;
    the sort is stable."""
    r, c = rays.count, boxes.shape[0]
    rpad = -(-r // block) * block
    comps = [torch.cat([x, x.new_zeros(rpad - r)]) for x in (*rays.p, *rays.d)]
    bits = torch.tensor([1 << b for b in range(c)], dtype=torch.int64,
                        device=boxes.device)
    passes = _perray_slab(comps, boxes)
    _, order = torch.sort((passes.long() * bits).sum(1), stable=True)
    union = (passes[order].view(-1, block, c).any(1).long() * bits).sum(1)
    rays8 = pack_rays_rows([x[order] for x in comps[:3]],
                           [x[order] for x in comps[3:]], rpad)
    return order, union.to(torch.int32), rays8


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


def pairs_plain(keys: torch.Tensor, rays8p: torch.Tensor, rows: torch.Tensor,
                k: int) -> torch.Tensor:
    """Plain PyTorch version of K12: (5, P) float32 rows [t (BIG on a
    miss), nx, ny, nz, mati], each pair tested against the K triangles of
    its cluster; keys C (the dummy) and above leave (BIG, 0, 0, 0, 0)."""
    p = keys.shape[0]
    c = rows.shape[0] // k - 1
    out = torch.zeros((5, p), device=rays8p.device)
    out[0] = BIG
    keys_s, order = torch.sort(keys, stable=True)
    runs, counts = torch.unique_consecutive(keys_s, return_counts=True)
    chunk = max(1, _PLAIN_CELLS // k)
    start = 0
    for ci, n in zip(runs.tolist(), counts.tolist()):
        if 0 <= ci < c:
            for s in range(start, start + n, chunk):
                idx = order[s:min(s + chunk, start + n)]
                tm, local = cluster_nearest(rows[ci * k:(ci + 1) * k],
                                            rays8p[:, idx])
                out[0, idx] = tm
                out[1:, idx] = torch.stack(
                    winner_attrs(rows, ci * k + local, tm < BIG))
        start += n
    return out


# A warp tests a sub-block for at most this many of its pairs together,
# all 32 lanes on one pair's rows (csrc/pair_vpu.cu); for more, each lane
# tests its own pair.
PAIR_COOP = 12
# K12's table of its skip rule: the rows' clusters, the dummy's included
# (its rows are all n = 0, so its sub-blocks are always skipped).
pair_sub_boxes = cluster_sub_boxes


def _check_pairs(keys, rays8p, rows, k, what):
    _build.check(keys, "keys", (None,), torch.int32)
    _build.check(rays8p, "rays8p", (8, keys.shape[0]))
    c1 = _cluster_count(rows, k, "rows")
    if keys.device != rays8p.device or rows.device != rays8p.device:
        raise ValueError(f"{what}'s tensors must be on one device")
    return c1


def _check_sub(sub, rows, k):
    c1 = rows.shape[0] // k
    _build.check(sub, "sub", (c1 * -(-k // SUB), 8))
    if sub.device != rows.device:
        raise ValueError("sub and rows must be on one device")


def run_pairs(keys: torch.Tensor, rays8p: torch.Tensor, rows: torch.Tensor,
              k: int, sub: torch.Tensor | None = None):
    """K12: (t, nx, ny, nz, mati), five (P,) float32 tensors, for the
    cluster-sorted pairs (keys (P,) int32 in 0..C, C the dummy; rays8p
    (8, P) [p d 0 0]) against the ((C + 1) K, 24) cluster rows, the dummy
    cluster's last. sub: the rows' `pair_sub_boxes` table, which the
    kernel needs (`make_pair_intersect` builds it once per scene; the
    plain version ignores it). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    c1 = _check_pairs(keys, rays8p, rows, k, "run_pairs")
    p = keys.shape[0]
    if rays8p.device.type == "cpu":
        return tuple(pairs_plain(keys, rays8p, rows, k))
    if sub is None:
        raise ValueError("run_pairs on CUDA tensors needs sub, the rows' "
                         "pair_sub_boxes table")
    _check_sub(sub, rows, k)
    out = torch.empty((5, p), dtype=torch.float32, device=rays8p.device)
    if p:
        _build.launch("pair_vpu", keys, rays8p, rows, sub, out, p, c1 - 1, k,
                      PAIR_COOP)
    return tuple(out)


def run_pairs_simt(keys: torch.Tensor, rays8p: torch.Tensor,
                   rows: torch.Tensor, k: int):
    """K12's first kernel (`csrc/pair_vpu.cu::pair_simt_kernel`: every
    (pair, triangle) test, one divide each), on CUDA tensors: run_pairs'
    rows. For the checks only (the smoke and the cuda tests hold the new
    kernel against it on whole launches and time the two in turns); no
    render path calls it."""
    c1 = _check_pairs(keys, rays8p, rows, k, "run_pairs_simt")
    if rays8p.device.type != "cuda":
        raise ValueError("run_pairs_simt runs on CUDA tensors only")
    p = keys.shape[0]
    out = torch.empty((5, p), dtype=torch.float32, device=rays8p.device)
    if p:
        _build.launch("pair_vpu_simt", keys, rays8p, rows, out, p, c1 - 1, k)
    return tuple(out)


def run_pairs_counted(keys: torch.Tensor, rays8p: torch.Tensor,
                      rows: torch.Tensor, k: int, sub: torch.Tensor):
    """run_pairs' kernel on CUDA tensors, also counting: (rows, (tests
    that reached the divide, (pair, sub-block) box tests that passed,
    those of them run by the whole warp, edge tests reached)). For the
    checks only; no render path calls it."""
    c1 = _check_pairs(keys, rays8p, rows, k, "run_pairs_counted")
    _check_sub(sub, rows, k)
    if rays8p.device.type != "cuda":
        raise ValueError("run_pairs_counted runs on CUDA tensors only")
    p = keys.shape[0]
    out = torch.empty((5, p), dtype=torch.float32, device=rays8p.device)
    count = torch.zeros(4, dtype=torch.int64, device=rays8p.device)
    if p:
        _build.launch("pair_vpu_count", keys, rays8p, rows, sub, out, p,
                      c1 - 1, k, PAIR_COOP, count)
    return tuple(out), tuple(int(x) for x in count.tolist())


def _pairs_round(comps, ids: torch.Tensor, rows: torch.Tensor, k: int,
                 c: int, trp: int, sub: torch.Tensor | None = None):
    """One VPU pairs round: comps, six (R,) ray components; ids, (L, R)
    rank-major candidate clusters (c = none). The pairs, sorted by
    cluster key with dummy pairs to whole tiles of trp
    (`pair_mxu.sort_pairs`), go through K12 and back to pair order; per
    ray the least t over its L pairs (the first rank on ties) and that
    pair's (nx, ny, nz, mati). sub: as run_pairs'."""
    l, r = ids.shape
    keys_s, rays8p, order = pair_mxu.sort_pairs(comps, ids, c, trp)
    outs = run_pairs(keys_s, rays8p, rows, k, sub)
    back = [torch.empty_like(o).index_copy_(0, order, o)[:r * l].reshape(l, r)
            for o in outs]
    best, which = back[0].min(0)                 # first rank on ties
    return (best,) + tuple(a.gather(0, which[None])[0] for a in back[1:])


def _check_pair_config(mxu, dop, move, infeat, thin, with_ids, approx, l3):
    """The JAX package's ValueErrors (sorted_intersect.py:750-784)."""
    if dop and not mxu:
        raise ValueError("dop=True requires mxu=True (DOP supports are built "
                         "from the march scene's cluster-ordered triangles)")
    if move not in ("gather", "sort", "chain"):
        raise ValueError(f"unknown move mode {move!r}")
    if infeat and not mxu:
        raise ValueError("infeat=True requires mxu=True")
    if thin and not mxu:
        raise ValueError("thin=True requires mxu=True (triangle ids come "
                         "from the cluster-ordered march packs)")
    if move == "chain":
        if not thin:
            raise ValueError("move='chain' requires thin=True")
        if l3 >= 64:
            raise ValueError("move='chain' folds march progress into a *128 "
                             "sort key; l3 must be < 64")
    if approx and with_ids:
        raise ValueError("approx=True returns (Hits, resolved) and skips the "
                         "escalations the ids overlay rides on; use it "
                         "without with_ids")
    if with_ids and not thin:
        raise ValueError("with_ids=True requires thin=True (only the thin "
                         "payload carries winner triangle ids)")
    if with_ids and move == "chain":
        raise ValueError("with_ids=True does not support move='chain'")


def make_pair_intersect(tris: TrianglesSoA, *, cluster_size: int = 512,
                        l1: int = 8, l2: int = 8, l3: int = 48,
                        trp: int = 1024, trb: int = 512, u2_frac: int = 2,
                        u3_frac: int = 32, tail: int = 8192,
                        mxu: bool = False, dop: bool = False,
                        move: str = "gather", infeat: bool = False,
                        thin: bool = False, with_ids: bool = False,
                        approx: bool = False):
    """The pair-expansion intersector (see the module docstring):
    intersect(rays) -> Hits, or (Hits, ids) with with_ids=True (ids: the
    winner's index in `tris`, -1 on a miss), or (Hits, resolved) with
    approx=True (round 1 only; resolved lanes are proven nearest). The
    defaults are the JAX package's (the 'pair' accel); `PAIR_TPU_WINNER`
    is 'pairwin', mxu=True with trp=512 'pairmx'. l1 and l2 are the ranks
    tested by round 1 and the first escalation, l3 the deepest (at most
    48, K9's selection), trb the candidate kernel's ray tile and trp the
    pair tile (together the padding unit), u2_frac and u3_frac the
    escalations' capacity fractions, tail the dense tail's rays per
    iteration. See `STATS` for the schedule's counts."""
    _check_pair_config(mxu, dop, move, infeat, thin, with_ids, approx, l3)
    if not all(0 < x <= MAX_RANKS for x in (l1, l2, l3)):
        raise ValueError(f"l1, l2 and l3 must be in 1..{MAX_RANKS}")
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
    else:
        big_isect = (make_pallas_intersect(big) if big is not None else None)
    if mxu:
        if with_ids:
            mscene, rt, c, march_order = build_march_scene(rest, cs,
                                                           with_order=True)
            gmap = np.full((c * cs,), -1, np.int32)
            gmap[:len(march_order)] = rest_idx[march_order]
            g_to_orig = torch.as_tensor(gmap, device=dev)
        else:
            mscene, rt, c = build_march_scene(rest, cs)
        boxes = [mscene.boxes_lo, mscene.boxes_hi,
                 torch.zeros((c, 2), device=dev)]
        if dop:
            boxes.append(pair_mxu.build_dops(rt, cs, c))
        boxes = torch.cat(boxes, dim=1)
        def run_pairs_fn(comps, ids):
            return pair_mxu.pairs_round_mxu(comps, ids, mscene, c, cs, trp,
                                            thin=thin, infeat=infeat)

        # The chain's dense tail: K1 over the march-ordered triangles, so
        # its winner row is the cluster-ordered id K11 decodes.
        chain_pack = build_tri_pack(rt, 1024) if move == "chain" else None
    else:
        cscene, c, _ = build_clusters(rest, cs, split_large=False)
        boxes = cscene.boxes
        # The dummy cluster C: all-zero (never-hit) rows for the pairs of
        # no cluster.
        rows = torch.cat([cscene.rows(),
                          torch.zeros((cs, TRI_COLS), device=dev)])
        sub = pair_sub_boxes(rows, cs) if dev.type == "cuda" else None

        def run_pairs_fn(comps, ids):
            return _pairs_round(comps, ids, rows, cs, c, trp, sub), None

    cp = _round_up(c, 128)
    boxes_r = torch.zeros((cp, boxes.shape[1]), device=dev)
    boxes_r[:c] = boxes
    # The TPU kernel's VMEM rule; it sets rpad through `unit`.
    while cp * trb > 480_000 and trb > 128:
        trb //= 2
    l1, l2, maxrank = min(l1, c), min(l2, c), min(l3, c)
    if with_ids:
        tail_pack = build_tri_pack(tris)
        n_cols = tuple(tris.n[:, k].contiguous() for k in range(3))
        mati_col = tris.mati.to(torch.float32)
        tail_isect = None
    else:
        tail_isect = make_pallas_intersect(tris)

    def window(ids_all, d0, w, sel):
        """The next w ranks of each ray from its progress d0 (c past
        sel)."""
        rows_ = d0[None, :] + torch.arange(w, device=d0.device)[:, None]
        return torch.where(rows_ < sel,
                           ids_all.gather(0, rows_.clamp(0, sel - 1)),
                           torch.full_like(ids_all[:1], c))

    def cert_bound(ents_all, nxt, d1, sel):
        """The entry of the first untested rank (nxt past sel)."""
        return torch.where(
            d1 < sel, ents_all.gather(0, d1.clamp(0, sel - 1)[None])[0], nxt)

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
        # The best so far: (t, g) with the thin payload, whose seed and
        # tail attributes live in `overlay` (g = -1 marks them), or
        # (t, nx, ny, nz, mati).
        if big_isect is not None:
            hb = big_isect(Rays(p=tuple(comps[:3]), d=tuple(comps[3:])))
            if with_ids:
                hb, bi = hb
                seed_ids = torch.where(hb.valid, big_map[bi.clamp(min=0)],
                                       seed_ids)
            seed_t = torch.where(hb.valid, hb.t, torch.full_like(hb.t, BIG))
            seed = [hb.n[0].clone(), hb.n[1].clone(), hb.n[2].clone(),
                    hb.mati.to(torch.float32)]
        else:
            seed_t = torch.full((rpad,), BIG, device=zeros.device)
            seed = [zeros.clone() for _ in range(4)]
        if thin:
            best = [seed_t, torch.full((rpad,), -1.0, device=zeros.device)]
            overlay = seed
        else:
            best = [seed_t] + seed

        def merge(idx, new):
            """Min-merge the new (t, ...) payload of rays idx, strict <."""
            cur = [b[idx] for b in best]
            merged = _merge_best(cur, new)
            for b, m in zip(best, merged):
                b[idx] = m
            return merged[0]

        def finish(resolved_out=None):
            """The Hits (thin: K11's attributes of the pair winners, the
            overlay's elsewhere), with ids or resolved as asked."""
            best_t = best[0]
            if not thin:
                hits = _hits_from_raw(rays, best_t, best[1:4], best[4], r)
            else:
                best_g = best[1]
                fn = pair_mxu.fetch_attrs(best_g, mscene.tric)
                use = best_g >= 0.0
                n3 = tuple(torch.where(use, f, o)
                           for f, o in zip(fn[:3], overlay))
                m = torch.where(use, fn[3], overlay[3])
                hits = _hits_from_raw(rays, best_t, n3, m, r)
            if resolved_out is not None:
                return hits, resolved_out[:r]
            if not with_ids:
                return hits
            g_int = best[1].to(torch.int64).clamp(0, g_to_orig.shape[0] - 1)
            ids = torch.where(best[1] >= 0.0, g_to_orig[g_int], seed_ids)
            ids = torch.where(best_t < BIG, ids, -1)
            return hits, ids[:r]

        # Round 1: every ray against its l1 nearest passing clusters.
        ids1, _, nxt1 = run_candidates(pack_rays(comps[:3], comps[3:]),
                                       boxes_r, l1, c)
        new1, pend = run_pairs_fn(comps, ids1)
        best[:] = _merge_best(best, new1)
        if pend is None:
            pend = torch.zeros(rpad, dtype=torch.bool, device=zeros.device)
        resolved = ((best[0] <= nxt1) | (nxt1 >= BIG)) & ~pend
        done = torch.full((rpad,), l1, dtype=torch.int64, device=zeros.device)
        if stats is not None:
            stats["round1_resolved"] = int(resolved[:r].sum())
            stats["escalations"] = []
        if approx:
            if stats is not None:
                STATS.append(stats)
            return finish(resolved)

        def first_unresolved(u):
            """The first u rays in (resolved, slot) order."""
            return torch.argsort(resolved.to(torch.int32), stable=True)[:u]

        def escalation(u, w, sel):
            """Test the next w untested ranks of the first u unresolved
            rays (selection depth sel) and merge."""
            idx = first_unresolved(u)
            if stats is not None:
                stats["escalations"].append(
                    (u, w, int((~resolved[idx]).sum())))
            sub = [x[idx] for x in comps]
            d0 = done[idx]
            ids_all, ents_all, nxt = run_candidates(
                pack_rays(sub[:3], sub[3:]), boxes_r, sel, c)
            new_sub, pend_sub = run_pairs_fn(sub, window(ids_all, d0, w, sel))
            d1 = torch.clamp(d0 + w, max=sel)
            bound = cert_bound(ents_all, nxt, d1, sel)
            t_m = merge(idx, new_sub)
            p_m = pend[idx]
            if pend_sub is not None:
                p_m = p_m | pend_sub
                pend[idx] = p_m
            done[idx] = torch.maximum(d0, d1)
            resolved[idx] = resolved[idx] | (
                ((t_m <= bound) | (bound >= BIG)) & ~p_m)

        u2 = max(unit, (rpad // u2_frac // unit) * unit)
        u3a = max(unit, (rpad // u2_frac // 4 // unit) * unit)
        u3b = max(unit, (rpad // u2_frac // 16 // unit) * unit)
        if move == "chain":
            _chain(comps, best, resolved, done, pend, u2, u3a, u3b, rpad,
                   stats)
        else:
            if l2 > l1:
                escalation(u2, l2 - l1, min(maxrank, l2))
            if maxrank > l2:
                w3 = maxrank - l2
                escalation(u3a, 8, min(maxrank, l2 + 8))
                escalation(u3b, w3, maxrank)
                u3 = max(unit, (rpad // u3_frac // unit) * unit)
                it = 0
                while it < 4 and bool((~resolved & (done < maxrank)).any()):
                    escalation(u3, w3, maxrank)
                    it += 1

        # The dense tail, `tail` rays at a time, until every ray is
        # resolved (after the chain: the rays that overflowed its region).
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
            if thin:
                better = new_t < best[0][idx]
                merge(idx, (new_t, torch.full_like(new_t, -1.0)))
                for o, a in zip(overlay, attrs):
                    o[idx] = torch.where(better, a, o[idx])
                if with_ids:
                    seed_ids[idx] = torch.where(
                        better, torch.where(hit, g1, -1).to(torch.int32),
                        seed_ids[idx])
            else:
                merge(idx, (new_t,) + tuple(attrs))
            resolved[idx] = True
            n_tail += 1
        if stats is not None:
            stats["tail_iterations"] = n_tail
            STATS.append(stats)
        return finish()

    def _chain(comps, best, resolved, done, pend, u2, u3a, u3b, rpad, stats):
        """`move='chain'` (thin): the escalations and the dense tail in
        chain space, in place on best, resolved, done and pend (see the
        module docstring)."""
        # Chain space: sorted by (resolved, slot); the key is unique.
        span = 1 << 25
        order = torch.argsort(resolved.long() * span
                              + torch.arange(rpad, device=resolved.device))
        st = {"slot": order, "res": resolved[order], "done": done[order],
              "pend": pend[order], "t": best[0][order], "g": best[1][order],
              "comps": [x[order] for x in comps]}

        def region_sort(n):
            key = st["res"][:n].long() * span + st["slot"][:n]
            perm = torch.argsort(key)
            for k in ("slot", "res", "done", "pend", "t", "g"):
                st[k][:n] = st[k][:n][perm]
            for x in st["comps"]:
                x[:n] = x[:n][perm]

        def escalate(u, w, sel):
            """The escalation's per-ray semantics on the prefix [:u]."""
            sub = [x[:u] for x in st["comps"]]
            d0 = st["done"][:u]
            if stats is not None:
                stats["escalations"].append(
                    (u, w, int((~st["res"][:u]).sum())))
            ids_all, ents_all, nxt = run_candidates(
                pack_rays(sub[:3], sub[3:]), boxes_r, sel, c)
            (t_new, g_new), pend_sub = run_pairs_fn(
                sub, window(ids_all, d0, w, sel))
            t0 = st["t"][:u]
            better = t_new < t0
            t1 = torch.where(better, t_new, t0)
            st["g"][:u] = torch.where(better, g_new, st["g"][:u])
            st["t"][:u] = t1
            d1 = torch.clamp(d0 + w, max=sel)
            bound = cert_bound(ents_all, nxt, d1, sel)
            p1 = st["pend"][:u] | pend_sub
            st["pend"][:u] = p1
            st["res"][:u] |= ((t1 <= bound) | (bound >= BIG)) & ~p1
            st["done"][:u] = torch.maximum(d0, d1)

        if l2 > l1:
            escalate(u2, l2 - l1, min(maxrank, l2))
        if maxrank > l2:
            region_sort(u2)
            escalate(u3a, 8, min(maxrank, l2 + 8))
            region_sort(u3a)
            escalate(u3b, maxrank - l2, maxrank)
        region_sort(u2)
        unres = int((~st["res"][:u2]).sum())
        u4c = min(tail, u2)
        k = 0
        while k * u4c < unres:
            off = min(k * u4c, rpad - u4c)
            sl = slice(off, off + u4c)
            sub = [x[sl] for x in st["comps"]]
            tt, gg = minarg(pack_rays(sub[:3], sub[3:]), chain_pack)
            better = tt < st["t"][sl]
            st["t"][sl] = torch.where(better, tt, st["t"][sl])
            st["g"][sl] = torch.where(better, gg, st["g"][sl])
            st["res"][sl] = True
            k += 1
        if stats is not None:
            stats["chain_tail_rays"] = unres
            stats["chain_tail_iterations"] = k
        slot = st["slot"]
        best[0][slot] = st["t"]
        best[1][slot] = st["g"]
        resolved[slot] = st["res"]
        done[slot] = st["done"]
        pend[slot] = st["pend"]

    return intersect
