"""K18: the block march (`accel='march'`), and K18m: its operand copy
(CUDA kernels and plain versions), on the cluster-ordered scene packs
that the pair intersector shares.

Port of `opencl_path_tracer_tpu/ops/pallas/march_kernel.py`:
`MarchScene` and `build_march_scene` (march_kernel.py:89-229), in numpy
on the host, bit-equal to the JAX package's packs; the visit kernel
`_march_kernel` (launched by `_run_march`, :232-415); `_slab_entries`
(:418-453); `_block_lists` (:456-484); `make_march_intersect`
(:487-692); `_pallas_materialize`'s copy `copy3` (K18m, :695-737) and
`_visited_from` (:740-747).

The triangles are put in Morton order of their centroids, scene-spanning
ones (bounding-box diagonal above a quarter of the scene's) first, and
cut into clusters of `cs`; every pack is in that cluster-major order:

* trig: (3 T', 32) bf16 Plucker rows, chunk = cs, so cluster k's edge e
  rows are [3 k cs + e cs, 3 k cs + (e + 1) cs) (`build_plucker_packs`);
* tric: (T', 24) float32, the triangle pack's 17 constants with the
  per-lane eps terms in columns 17-22: edge k is accepted by the visit
  when E_k >= -(col(17 + k) m + col(20 + k)), m the lane's
  max |P x D|;
* boxes_lo, boxes_hi: (C, 3) float32 cluster boxes, inflated by
  1e-4 diag + 1e-3 so a hit on a hull triangle is never lost to the slab
  test's rounding;
* scene_lo, scene_inv: (3,) float32, the scene box's corner and inverse
  extent, which place ray origins in Morton cells for the lane sort.

K18 (`run_march`): lanes sorted by (direction octant, origin Morton cell)
form blocks of `tr`; block b visits the K clusters clist[b K : (b + 1) K]
(-1: a dummy visit, which changes nothing). A visit is K10's
(`pair_mxu._visit`, `csrc/march_visit.cuh`): the conservative bf16
Plucker edge tests, the exact t, the two least candidates and K1's exact
test on each; visits merge by (t, g) lexicographic minimum, g = cluster
cs + index, and pend by maximum. K18 writes seven rows (t, nx, ny, nz,
mati, g, pend): the winner's normal and material are its tric row's
columns 0-2 and 16 plus +0.0 (the TPU's one-hot fetch over the exact
bf16 3-split turns -0.0 into +0.0); (BIG, 0, 0, 0, 0, 0) without a hit.

K18's kernel (`csrc/march.cu` over `csrc/march_mma.cuh`) computes the
edge values E_k on the tensor cores and decides an edge test from them
only outside a certified margin, recomputing the float32 chain inside it:
its rows are the first kernel's bit for bit (`run_march_simt`, every
product on the float32 cores, `csrc/march_visit.cuh`). `run_march_simt`
and `run_march_counted` (the same kernel, counting the edge tests the
margin sent to the chain) serve the checks only; no render path calls
them.

K18m (`materialize`) copies clist, the sorted rays and their features
before every K18 launch. On the TPU the copy forces XLA to materialize
the kernel's operands; on the card it is a plain copy, launched where the
JAX package launches it so its cost is measured.

`make_march_intersect` runs the JAX package's schedule: round 1 (K18 over
every block's K1 nearest needed clusters), certification (a lane is
resolved when every cluster whose box entry is below its best t was in
its block's list, and no visit left it pending), round 2 (K18 over the
first quarter of lanes in (resolved, slot) order with K2 clusters, their
round-1 block's clusters counting as visited; a lane round 1 left
pending is not resolved by round 2, where the JAX package forgets it and
can keep a farther hit), a dense tail (K4 over the
reordered triangles, `tail` lanes per iteration and one host read each,
until every lane is resolved), and the unsort. Its hits equal K4's over
the reordered triangles bit for bit.

Sorts that decide work are stable (`torch.sort(stable=True)`), which is
the permutation the JAX package's two-key sorts (key, iota) compute, and
each round's visited set is derived from the very list K18 reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.accel.lbvh import morton3
from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.types import Hits, Rays
from opencl_path_tracer_tpu_torch.models.wavefront import morton3_components
from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.ops.kernels.cluster_kernel import (
    _xmax, _xmin,
)
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    BIG, TRI_COLS, _round_up, build_tri_pack, make_pallas_intersect,
    pack_rays,
)
from opencl_path_tracer_tpu_torch.ops.kernels.pair_mxu import _visit
from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
    EPS_SCALE, _bf16_np, _bf16_tensor_np, build_plucker_packs, plucker_feat,
)

MARCH_LANES = 128         # lanes per CUDA block of csrc/march_visit.cuh
_PLAIN_CELLS = 1 << 22    # (lane, triangle) tests per batch of the plain visits
_SLAB_CELLS = 1 << 27     # (cluster, lane) entries per chunk of _slab_entries

# Set to a list to make every march or flat intersector call append a
# dict of its schedule's counts (lanes, lanes resolved after round 1 and
# after round 2 (flat: after its round 1, with its visits and overflowed
# blocks), the tail's lanes and iterations, pending flags of each round);
# None (the default) records nothing.
STATS = None


@dataclasses.dataclass(frozen=True)
class MarchScene:
    """Cluster-ordered scene constants (see the module docstring)."""

    trig: torch.Tensor       # (3 T', 32) bfloat16
    tric: torch.Tensor       # (T', 24) float32
    boxes_lo: torch.Tensor   # (C, 3) float32
    boxes_hi: torch.Tensor   # (C, 3) float32
    scene_lo: torch.Tensor   # (3,) float32
    scene_inv: torch.Tensor  # (3,) float32


def build_march_scene(tris: TrianglesSoA, cs: int = 512,
                      with_order: bool = False):
    """(scene, reordered triangles, C), or with with_order=True also the
    (T,) int32 permutation: cluster-ordered row j is input triangle
    order[j]. The packs live on the triangles' device."""
    t_count = tris.count
    c = max(1, -(-t_count // cs))
    total = c * cs
    dev = tris.device
    r1, r2, r3 = (getattr(tris, f).cpu().numpy() for f in ("r1", "r2", "r3"))
    lo = np.minimum(np.minimum(r1, r2), r3)
    hi = np.maximum(np.maximum(r1, r2), r3)
    mid = (r1 + r2 + r3) / 3.0
    scene_lo = lo.min(0)
    extent = np.maximum(hi.max(0) - scene_lo, 1e-9)
    codes = morton3((mid - scene_lo) / extent)
    diag = np.linalg.norm(hi - lo, axis=1)
    scene_diag = float(np.linalg.norm(hi.max(0) - lo.min(0)))
    codes = np.where(diag > 0.25 * scene_diag,
                     np.uint32(0), codes | np.uint32(1 << 30))
    order = np.argsort(codes, kind="stable").astype(np.int32)
    rt = tris.take(order)

    trig, _, tpad = build_plucker_packs(rt, chunk=cs, tt=cs)
    tab = build_tri_pack(rt, cs).cpu().numpy()
    if tab.shape[0] < tpad:
        tab = np.concatenate(
            [tab, np.zeros((tpad - tab.shape[0], 24), np.float32)])
    tric = tab.copy()
    # Two-part conservative eps per edge (march_kernel.py:160-180):
    # accept iff E_k >= -(epsA_k m_lane + epsB_k).
    n64 = tab[:, 0:3].astype(np.float64)
    c064 = tab[:, 3].astype(np.float64)
    live = np.abs(n64).sum(1) > 0
    for k in range(3):
        m64 = tab[:, 4 + 4 * k:7 + 4 * k].astype(np.float64)
        d64 = tab[:, 7 + 4 * k].astype(np.float64)
        wc = np.cross(m64, n64)
        wd = c064[:, None] * m64 - d64[:, None] * n64
        tric[:, 17 + k] = np.where(live, EPS_SCALE * np.abs(wc).sum(1) * 1.01,
                                   1e-30)
        tric[:, 20 + k] = np.where(live, EPS_SCALE * np.abs(wd).sum(1) * 1.01,
                                   1e-30)

    # Cluster boxes over the reordered triangles (padding rows empty).
    tlo, thi = lo[order], hi[order]
    pad = total - t_count
    if pad:
        tlo = np.concatenate([tlo, np.full((pad, 3), np.inf)])
        thi = np.concatenate([thi, np.full((pad, 3), -np.inf)])
    blo = tlo.reshape(c, cs, 3).min(1)
    bhi = thi.reshape(c, cs, 3).max(1)
    bdiag = np.linalg.norm(
        np.where(np.isfinite(bhi - blo), bhi - blo, 0.0), axis=1,
        keepdims=True)
    delta = 1e-4 * bdiag + 1e-3
    blo = np.where(np.isfinite(blo), blo - delta, blo)
    bhi = np.where(np.isfinite(bhi), bhi + delta, bhi)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    scene = MarchScene(trig=trig, tric=f32(tric), boxes_lo=f32(blo),
                       boxes_hi=f32(bhi), scene_lo=f32(scene_lo),
                       scene_inv=f32(1.0 / extent))
    if with_order:
        return scene, rt, c, order
    return scene, rt, c


def split_bf16x3(tric: torch.Tensor) -> torch.Tensor:
    """The TPU's tab3 (march_kernel.py:177-191): (64, T') bfloat16, rows
    0-16, 17-33 and 34-50 the hi, mid and lo bf16 parts of tric's 17
    constants, whose sum is the float32 value exactly."""
    t17 = tric[:, :17].cpu().numpy().T
    hi_ = _bf16_np(t17)
    mid_ = _bf16_np(t17 - hi_)
    lo_ = _bf16_np(t17 - hi_ - mid_)
    if not (hi_.astype(np.float64) + mid_.astype(np.float64)
            + lo_.astype(np.float64) == t17.astype(np.float64)).all():
        raise RuntimeError("bf16 3-way split failed to reconstruct the "
                           "float32 table exactly")
    tab3 = np.zeros((64, t17.shape[1]), np.float32)
    tab3[0:17], tab3[17:34], tab3[34:51] = hi_, mid_, lo_
    return _bf16_tensor_np(tab3, tric.device)


def lane_key(p, d, scene: MarchScene) -> torch.Tensor:
    """(N,) int64 lane sort key (octant << 27) | (Morton cell >> 3) of
    the rays (p, d: three (N,) float32 components each), the origins
    placed in the scene box (march_kernel.py:510-521)."""
    q = tuple(torch.clamp((p[k] - scene.scene_lo[k]) * scene.scene_inv[k],
                          0.0, 1.0) for k in range(3))
    octant = ((d[0] >= 0).long() * 4 + (d[1] >= 0).long() * 2
              + (d[2] >= 0).long())
    return (octant << 27) | (morton3_components(q) >> 3)


def _slab_axis(tmin, tmax, bl, bh, p, d):
    """One slab of a ray-box test (d == 0: containment), with XLA's
    NaN-aware min and max, as the JAX package's slab passes."""
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


def _slab_entries(rays8s: torch.Tensor, scene: MarchScene,
                  best_t: torch.Tensor):
    """(C, N) entry distances (BIG where the slab test fails) and the
    (C, N) NEED mask (the test passes and the entry is below best_t).
    Computed in chunks of lanes: the pass is elementwise, so the chunks
    do not change the bits, and at 1080p one (C, N) float32 temporary is
    1.6 GB at C = 195."""
    lo, hi = scene.boxes_lo, scene.boxes_hi
    c, n = lo.shape[0], rays8s.shape[1]
    ent = torch.empty((c, n), dtype=torch.float32, device=rays8s.device)
    step = max(1, _SLAB_CELLS // c)
    for s in range(0, n, step):
        x = rays8s[:, s:s + step]
        tn = torch.full((c, x.shape[1]), -BIG, device=x.device)
        tm = torch.full_like(tn, BIG)
        for ax in range(3):
            tn, tm = _slab_axis(tn, tm, lo[:, ax, None], hi[:, ax, None],
                                x[ax][None], x[3 + ax][None])
        ok = (tm >= tn) & (tm >= 0.0)
        ent[:, s:s + step] = torch.where(ok, _xmax(tn, torch.zeros_like(tn)),
                                         torch.full_like(tn, BIG))
    return ent, _need(ent, best_t)


def _need(ent: torch.Tensor, best_t: torch.Tensor) -> torch.Tensor:
    """`_slab_entries`' NEED mask for another bound best_t: the entry is
    BIG where the slab test fails, and best_t is at most BIG, so
    `passes & (ent < best_t)` is `ent < best_t`."""
    return ent < best_t[None, :]


def _block_lists(ent: torch.Tensor, need: torch.Tensor, tr: int, K: int):
    """(B K,) int32: each block of tr lanes' K nearest clusters that some
    lane of it needs, nearest block entry first (a stable sort: the
    entries tie heavily at 0), -1 past the needed ones."""
    c, n = ent.shape
    b = n // tr
    block_any = need.view(c, b, tr).any(dim=2)
    block_ent = torch.where(block_any, ent.view(c, b, tr).amin(dim=2),
                            torch.full((c, b), BIG, device=ent.device))
    order = torch.argsort(block_ent, dim=0, stable=True)
    k = min(K, c)
    topk = order[:k]
    clist = torch.where(block_any.gather(0, topk), topk,
                        torch.full_like(topk, -1)).to(torch.int32)
    if k < K:
        clist = torch.cat([clist, torch.full((K - k, b), -1, dtype=torch.int32,
                                             device=ent.device)])
    return clist.t().reshape(-1).contiguous()


def _visited_from(clist: torch.Tensor, C: int, K: int) -> torch.Tensor:
    """(C, B) bool: cluster c is in block b's list, derived from the very
    list the kernel reads."""
    cl2 = clist.view(-1, K)
    return (cl2[None, :, :] == torch.arange(C, device=clist.device)[
        :, None, None]).any(dim=2)


def _visits_plain(rays8s, feat, scene: MarchScene, cs: int, tr: int, vb,
                  vc):
    """(found, t, g, pend), (V, tr) each, of the visits of blocks vb (V,)
    to clusters vc (V,) (>= 0), in batches of _PLAIN_CELLS tests."""
    nb = rays8s.shape[1] // tr
    rays_t = rays8s.view(8, nb, tr)
    feat_t = feat[:18].to(torch.float32).view(18, nb, tr)
    per = max(1, _PLAIN_CELLS // (cs * tr))
    parts = [_visit(rays_t[:, vb[s:s + per]], feat_t[:, vb[s:s + per]],
                    scene.trig, scene.tric, vc[s:s + per], cs)
             for s in range(0, vb.numel(), per)]
    if not parts:
        z = torch.zeros((0, tr), device=rays8s.device)
        return z.bool(), z, z, z.bool()
    return tuple(torch.cat(x) for x in zip(*parts))


def _merge_plain(rows0, vb, found, t, g, pend, tric, tr: int):
    """Merge visits into the (7, N) rows0 [t nx ny nz mati g pend] of the
    blocks vb: the (t, g) lexicographic minimum over found hits replaces
    a block lane's row when strictly below it (attributes from its tric
    row + 0.0); pend is the maximum."""
    nb = rows0.shape[1] // tr
    r0 = rows0.view(7, nb, tr)
    inf = torch.full((nb, tr), float("inf"), device=rows0.device)
    idx = vb[:, None].expand(-1, tr)
    tmin = inf.clone().scatter_reduce_(
        0, idx, torch.where(found, t, float("inf")), "amin")
    at = found & (t == tmin[vb])
    gmin = inf.clone().scatter_reduce_(
        0, idx, torch.where(at, g, float("inf")), "amin")
    bet = (tmin < r0[0]) | ((tmin == r0[0]) & (gmin < r0[5]))
    rows = tric[torch.where(bet, gmin, 0.0).long().view(-1)].view(nb, tr, -1)
    out = r0.clone()
    out[0] = torch.where(bet, tmin, r0[0])
    for j, col in ((1, 0), (2, 1), (3, 2), (4, 16)):
        out[j] = torch.where(bet, rows[..., col] + 0.0, r0[j])
    out[5] = torch.where(bet, gmin, r0[5])
    out[6] = torch.zeros_like(inf).scatter_reduce_(
        0, idx, pend.to(torch.float32), "amax").maximum(r0[6])
    return out.view(7, -1)


def miss_rows(n: int, device) -> torch.Tensor:
    """(7, n) float32 rows of lanes that found nothing: t = BIG, the rest
    0 (K18's start)."""
    rows = torch.zeros((7, n), dtype=torch.float32, device=device)
    rows[0] = BIG
    return rows


def march_plain(clist, rays8s, feat, scene: MarchScene, cs: int, K: int,
                tr: int) -> torch.Tensor:
    """Plain PyTorch version of K18: (7, N) rows [t nx ny nz mati g pend]."""
    n = rays8s.shape[1]
    vb = torch.arange(n // tr, device=clist.device).repeat_interleave(K)
    vc = clist.long()
    live = vc >= 0
    vb, vc = vb[live], vc[live]
    res = _visits_plain(rays8s, feat, scene, cs, tr, vb, vc)
    return _merge_plain(miss_rows(n, rays8s.device), vb, *res, scene.tric, tr)


def check_march_inputs(rays8s, feat, scene: MarchScene, cs: int, tr: int,
                       what: str) -> int:
    """Raise unless the sorted rays (8, N), features (32, N) and packs suit
    the visit kernels (N a multiple of tr, tr of MARCH_LANES, cs of 64);
    returns C."""
    _build.check(rays8s, "rays8s", (8, None))
    n = rays8s.shape[1]
    _build.check(feat, "feat", (32, n), dtype=torch.bfloat16)
    _build.check(scene.tric, "tric", (None, TRI_COLS))
    _build.check(scene.trig, "trig", (3 * scene.tric.shape[0], 32),
                 dtype=torch.bfloat16)
    c = scene.boxes_lo.shape[0]
    if not (rays8s.device == feat.device == scene.tric.device
            == scene.trig.device):
        raise ValueError(f"{what}: rays8s, feat and the packs must be on "
                         "one device")
    if (n % tr or tr % MARCH_LANES or cs % 64 or cs <= 0
            or scene.tric.shape[0] < c * cs or c * cs >= 1 << 22):
        raise ValueError(f"{what} needs N a multiple of tr, tr a multiple "
                         f"of {MARCH_LANES}, cs of 64 and packs of C cs < "
                         f"2^22 rows; got N {n}, tr {tr}, cs {cs}, "
                         f"{scene.tric.shape[0]} rows for C {c}")
    return c


def _check_run_march(clist, rays8s, feat, scene: MarchScene, cs: int,
                     K: int, tr: int, what: str) -> None:
    c = check_march_inputs(rays8s, feat, scene, cs, tr, what)
    n = rays8s.shape[1]
    _build.check(clist, "clist", (n // tr * K,), dtype=torch.int32)
    if clist.device != rays8s.device:
        raise ValueError("clist and rays8s must be on one device")
    if clist.numel() and int(clist.max()) >= c:
        raise ValueError(f"clist names a cluster past C = {c}")


def run_march(clist, rays8s, feat, scene: MarchScene, cs: int, K: int,
              tr: int) -> torch.Tensor:
    """K18: (7, N) float32 rows [t nx ny nz mati g pend] of the sorted
    lanes rays8s (8, N) with features feat (32, N) bfloat16, block b of
    tr lanes visiting the clusters clist[b K : (b + 1) K] ((B K,) int32,
    -1 a dummy). CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    _check_run_march(clist, rays8s, feat, scene, cs, K, tr, "run_march")
    n = rays8s.shape[1]
    if rays8s.device.type == "cpu":
        return march_plain(clist, rays8s, feat, scene, cs, K, tr)
    out = torch.empty((7, n), dtype=torch.float32, device=rays8s.device)
    if n:
        _build.launch("march", clist, rays8s, feat, scene.trig, scene.tric,
                      out, n, K, tr, cs)
    return out


def _launch_entry(entry: str, clist, rays8s, feat, scene: MarchScene,
                     cs: int, K: int, tr: int, *extra) -> torch.Tensor:
    _check_run_march(clist, rays8s, feat, scene, cs, K, tr, entry)
    if rays8s.device.type != "cuda":
        raise ValueError(f"{entry} runs on CUDA tensors only")
    n = rays8s.shape[1]
    out = torch.empty((7, n), dtype=torch.float32, device=rays8s.device)
    if n:
        _build.launch(entry, clist, rays8s, feat, scene.trig, scene.tric,
                      out, n, K, tr, cs, *extra)
    return out


def run_march_simt(clist, rays8s, feat, scene: MarchScene, cs: int, K: int,
                   tr: int) -> torch.Tensor:
    """K18's first kernel, every product on the float32 cores
    (`csrc/march.cu::march_simt_kernel` over `march_visit.cuh`), on CUDA
    tensors: run_march's rows. For the checks only (the smoke and the
    cuda tests hold the tensor-core kernel against it on whole launches
    and time the two in turns); no render path calls it."""
    return _launch_entry("march_simt", clist, rays8s, feat, scene, cs, K, tr)


def run_march_counted(clist, rays8s, feat, scene: MarchScene, cs: int,
                      K: int, tr: int):
    """run_march's kernel on CUDA tensors, also counting the edge tests
    its margin sent to the float32 chain: ((7, N) rows, the count as an
    int). For the checks only; no render path calls it."""
    count = torch.zeros(1, dtype=torch.int64, device=rays8s.device)
    out = _launch_entry("march_count", clist, rays8s, feat, scene, cs, K, tr,
                        count)
    return out, int(count.item())


def materialize_plain(clist, rays8s, feat):
    """Plain PyTorch version of K18m: copies of the three tensors."""
    return tuple(torch.empty_like(x).copy_(x) for x in (clist, rays8s, feat))


def materialize(clist, rays8s, feat):
    """K18m: copies (clist, rays8s, feat) of the (L,) int32 list, the
    (8, N) float32 rays and the (32, N) bfloat16 features, byte for byte
    at any storage offset. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    _build.check(clist, "clist", (None,), dtype=torch.int32)
    _build.check(rays8s, "rays8s", (8, None))
    _build.check(feat, "feat", (32, rays8s.shape[1]), dtype=torch.bfloat16)
    if not clist.device == rays8s.device == feat.device:
        raise ValueError("clist, rays8s and feat must be on one device")
    if rays8s.device.type == "cpu":
        return materialize_plain(clist, rays8s, feat)
    outs = tuple(torch.empty_like(x) for x in (clist, rays8s, feat))
    _build.launch("materialize", clist, rays8s, feat, *outs, clist.numel(),
                  rays8s.numel(), feat.numel())
    return outs


def merge_best(best, new):
    """Replace best (six (N,) rows t nx ny nz mati g) by new where new's
    (t, g) is lexicographically below."""
    bet = (new[0] < best[0]) | ((new[0] == best[0]) & (new[5] < best[5]))
    return [torch.where(bet, x, b) for x, b in zip(new, best)]


def dense_tail(best, res, rays8s, tail_isect, u: int):
    """The unconditional net: K4 over the reordered triangles for the
    first u lanes in (resolved, slot) order, assigned (not merged: K4 is
    canonical), until every lane is resolved. One host read per
    iteration. Returns the iterations and the lanes it took."""
    iters = lanes = 0
    while not bool(res.all()):
        idx = torch.argsort(res.to(torch.int32), stable=True)[:u]
        lanes += int((~res[idx]).sum()) if STATS is not None else 0
        ht = tail_isect(Rays(p=tuple(rays8s[k][idx] for k in range(3)),
                             d=tuple(rays8s[k][idx] for k in range(3, 6))))
        newt = torch.where(ht.valid, ht.t, torch.full_like(ht.t, BIG))
        news = (newt, ht.n[0], ht.n[1], ht.n[2],
                ht.mati.to(torch.float32), torch.zeros_like(newt))
        for b, m in zip(best, news):
            b[idx] = m
        res[idx] = True
        iters += 1
    return iters, lanes


def unsort_hits(rays: Rays, best, order) -> Hits:
    """Hits in the caller's ray order from the sorted lanes' rows (t BIG
    on a miss): t = -1, p = 0 and mati = 0 on a miss; the normal rows
    pass through."""
    r = rays.count
    if order is not None:
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.numel(), device=order.device)
        best = [b[inv] for b in best]
    bt, nx, ny, nz, m = (b[:r] for b in best[:5])
    any_hit = bt < BIG
    z = torch.zeros_like(bt)
    safe_t = torch.where(any_hit, bt, z)
    return Hits(
        t=torch.where(any_hit, bt, torch.full_like(bt, -1.0)),
        p=tuple(torch.where(any_hit, rays.p[k] + rays.d[k] * safe_t, z)
                for k in range(3)),
        n=(nx, ny, nz),
        mati=torch.where(any_hit, m, z).to(torch.int32),
    )


def make_march_intersect(tris: TrianglesSoA, *, cs: int = 512,
                         tr: int = 512, K1: int = 24, K2: int = 64,
                         tail: int = 16384, debug: bool = False):
    """(intersect(rays) -> Hits, reordered triangles): the 'march' accel
    (see the module docstring). Hits equal K4's over the reordered
    triangles bit for bit. debug=True makes intersect return (hits,
    dict) with the JAX package's debug values (res1, pend1, idx2, unc2,
    pend2, res_pre_tail, best_pre_tail_t, best_sorted_t, order_l)."""
    scene, rt, c = build_march_scene(tris, cs)
    tail_isect = make_pallas_intersect(rt)

    def intersect(rays: Rays):
        rpad = _round_up(rays.count, tr)
        rays8 = pack_rays(rays.p, rays.d, rpad)
        order_l = torch.sort(lane_key(rays8[0:3], rays8[3:6], scene),
                             stable=True).indices
        rays8s = rays8[:, order_l]
        feat = plucker_feat(rays8s)
        best = list(miss_rows(rpad, rays8.device)[:6])

        # Round 1: every block's K1 nearest needed clusters.
        ent, need = _slab_entries(rays8s, scene, best[0])
        clist, r8m, fm = materialize(_block_lists(ent, need, tr, K1), rays8s,
                                     feat)
        visited = _visited_from(clist, c, K1)
        outs = run_march(clist, r8m, fm, scene, cs, K1, tr)
        best = merge_best(best, outs[:6])
        pend1 = outs[6] > 0.0

        # Certification: every cluster that could still beat the best t
        # was in the block's list, and no visit left the lane pending.
        b = rpad // tr
        unc1 = (_need(ent, best[0]).view(c, b, tr)
                & ~visited.view(c, b, 1)).any(dim=0).reshape(-1)
        res = ~(unc1 | pend1)
        res1 = res.clone()
        del ent, need

        # Round 2: the first u2 lanes in (resolved, slot) order.
        u2 = min(max(tr, _round_up(rpad // 4, tr)), rpad)
        idx2 = torch.argsort(res.to(torch.int32), stable=True)[:u2]
        rays2 = rays8s[:, idx2]
        feat2 = plucker_feat(rays2)
        ent2, need2 = _slab_entries(rays2, scene, best[0][idx2])
        clist2, r8m2, fm2 = materialize(_block_lists(ent2, need2, tr, K2),
                                        rays2, feat2)
        visited2 = _visited_from(clist2, c, K2)
        outs2 = run_march(clist2, r8m2, fm2, scene, cs, K2, tr)
        pend2 = outs2[6] > 0.0
        merged = merge_best([x[idx2] for x in best], outs2[:6])
        for x, m in zip(best, merged):
            x[idx2] = m
        # A round-2 lane's coverage is its round-1 block's clusters too.
        unc2 = (need2 & ~visited[:, idx2 // tr]
                & ~visited2.repeat_interleave(tr, dim=1)[:, :u2]).any(dim=0)
        del ent2, need2
        # A lane round 1 left pending stays unresolved: the visit that
        # pended counts as visited, so round 2 may never test its
        # cluster again. (The JAX package drops pend1 here, and 2 of
        # 2,073,600 stress first-bounce rays then kept a farther hit than
        # K4's; ROADMAP.md queue 3.)
        res[idx2] = res[idx2] | ~(unc2 | pend2 | pend1[idx2])

        res_pre_tail = res.clone()
        best_pre_tail_t = best[0].clone()
        iters, lanes = dense_tail(best, res, rays8s, tail_isect,
                                  min(tail, rpad))
        if STATS is not None:
            STATS.append({"lanes": rpad, "round1_resolved": int(res1.sum()),
                          "round2_resolved": int(res_pre_tail.sum()),
                          "tail_lanes": lanes, "tail_iterations": iters,
                          "pending": int(pend1.sum() + pend2.sum())})
        hits = unsort_hits(rays, best, order_l)
        if debug:
            return hits, dict(res_pre_tail=res_pre_tail, order_l=order_l,
                              best_pre_tail_t=best_pre_tail_t,
                              best_sorted_t=best[0], res1=res1, idx2=idx2,
                              unc2=unc2, pend2=pend2, pend1=pend1)
        return hits

    return intersect, rt
