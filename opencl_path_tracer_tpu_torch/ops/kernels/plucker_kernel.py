"""K2: attributes of the K1 winner, K14: K1 and K2 in one launch, and
K13a/K13b: the Plucker top-2 candidates and their exact re-test (CUDA
kernels and plain versions), with the intersectors that chain them.

Port of `opencl_path_tracer_tpu/ops/pallas/plucker_kernel.py`:
`_refine1_kernel` (launched by `_run_refine1`), `_minarg_fused_kernel`
(launched by `_run_minarg_fused`) and `make_minarg_intersect`;
`_cand_kernel` (launched by `_run_candidates`),
`_refine_kernel` (launched by `_run_refine`), `build_plucker_packs`,
`plucker_feat`, `_split_bf16_exact` and `make_plucker_intersect`.

On the TPU the winner's normal and material come out of a one-hot
matmul over a bf16 three-way split of the triangle table; the split is
exact, so the fetch returns the float32 constants bit for bit, except
that the one-hot sum turns a -0.0 into +0.0. On Hopper the fetch is an
indexed load, with `+ 0.0` reproducing the sign of zero. On a miss
(t1 >= BIG) t = -1; the normal and material then belong to triangle 0,
as on the TPU (the callers mask them).
"""

from __future__ import annotations

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.types import Hits, Rays
from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.ops.kernels.cluster_kernel import sub_boxes
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    BIG, TRI_COLS, _dot3, _round_up, assemble_hits, build_tri_pack,
    check_dense, minarg, minarg_plain, pack_rays,
)

# K14's warp tests a sub-block for at most this many of its rays together,
# all 32 lanes on one ray's rows (csrc/minarg_fused.cu); for more, each
# lane tests its own ray. 12, 16 and 24 measured within 0.3 % on the
# Cornell camera and first-bounce rays, 4 up to 11 % slower and 32
# 1.3-1.5x (runtime/cull_ab.py --coop; PERF.md).
MINARG_FUSED_COOP = 16


def refine1_plain(t1: torch.Tensor, g1: torch.Tensor,
                  tri_pack: torch.Tensor):
    """Plain PyTorch version of K2: (t, nx, ny, nz, m), (R,) float32."""
    rows = tri_pack[g1.long()]
    t = torch.where(t1 < BIG, t1, torch.full_like(t1, -1.0))
    return (t, rows[:, 0] + 0.0, rows[:, 1] + 0.0, rows[:, 2] + 0.0,
            rows[:, 16] + 0.0)


def refine1(t1: torch.Tensor, g1: torch.Tensor, tri_pack: torch.Tensor):
    """K2 on K1's (t, g). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    _build.check(t1, "t1", (None,))
    _build.check(g1, "g1", (t1.shape[0],))
    _build.check(tri_pack, "tri_pack", (None, TRI_COLS))
    if not (t1.device == g1.device == tri_pack.device):
        raise ValueError("t1, g1 and tri_pack must be on one device")
    if tri_pack.shape[0] == 0:
        raise ValueError("refine1 needs at least one triangle")
    if t1.device.type == "cpu":
        return refine1_plain(t1, g1, tri_pack)
    r = t1.shape[0]
    outs = [torch.empty(r, dtype=torch.float32, device=t1.device)
            for _ in range(5)]
    _build.launch("refine1", t1, g1, tri_pack, *outs, r, tri_pack.shape[0])
    return tuple(outs)


def minarg_fused_plain(rays8: torch.Tensor, tri_pack: torch.Tensor):
    """Plain PyTorch version of K14: K1's (t, index), then K2's fetch;
    (t, nx, ny, nz, m), (R,) float32, t = -1 on a miss."""
    return refine1_plain(*minarg_plain(rays8, tri_pack), tri_pack)


def start_flags(n_rays: int, device) -> torch.Tensor:
    """K14's scratch between its two kernels: a bit for each ray that
    row 0 may accept above BIG (csrc/minarg_fused.cu), int32 words."""
    return torch.empty(-(-n_rays // 32), dtype=torch.int32, device=device)


def _check_minarg_fused(rays8, tri_pack, sub, what):
    """(R, K14's five output rows) after `check_dense`."""
    r = check_dense(rays8, tri_pack, sub, what)
    return r, [torch.empty(r, dtype=torch.float32, device=rays8.device)
               for _ in range(5)]


def minarg_fused(rays8: torch.Tensor, tri_pack: torch.Tensor,
                 sub: torch.Tensor | None = None):
    """K14: K1's exact min + argmin and K2's attribute fetch in one
    launch, for each ray of the (8, R) pack against the (T, 24) triangle
    pack: (t, nx, ny, nz, m), five (R,) float32 tensors, bit for bit K1
    then K2. sub: the pack's table of the skip rule,
    `cluster_kernel.sub_boxes(tri_pack, [(0, T)])`, which the kernel needs
    (`make_minarg_intersect(fuse_fetch=True)` builds it once per scene; the
    plain version ignores it). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    r, outs = _check_minarg_fused(rays8, tri_pack, sub, "minarg_fused")
    if rays8.device.type == "cpu":
        return minarg_fused_plain(rays8, tri_pack)
    if sub is None:
        raise ValueError("minarg_fused on CUDA tensors needs sub, the "
                         "pack's sub_boxes table")
    _build.launch("minarg_fused", rays8, tri_pack, sub, *outs,
                  start_flags(r, rays8.device), r, tri_pack.shape[0],
                  MINARG_FUSED_COOP)
    return tuple(outs)


def minarg_fused_simt(rays8: torch.Tensor, tri_pack: torch.Tensor):
    """K14's first kernel (`csrc/minarg_fused.cu::minarg_fused_simt_kernel`,
    nearest.cuh's loop: every row staged for the block, every (ray,
    triangle) test run), on CUDA tensors: minarg_fused's outputs. For the
    checks only (the smoke and the cuda tests hold the new kernel against
    it and time the two in turns); no render path calls it."""
    r, outs = _check_minarg_fused(rays8, tri_pack, None, "minarg_fused_simt")
    if rays8.device.type != "cuda":
        raise ValueError("minarg_fused_simt runs on CUDA tensors only")
    _build.launch("minarg_fused_simt", rays8, tri_pack, *outs, r,
                  tri_pack.shape[0])
    return tuple(outs)


def minarg_fused_counted(rays8: torch.Tensor, tri_pack: torch.Tensor,
                         sub: torch.Tensor):
    """minarg_fused's kernel on CUDA tensors, also counting: (outputs,
    (tests that reached the divide, (ray, sub-block) box tests that
    passed, those of them run by the whole warp, edge tests reached, box
    tests made)). For the checks only; no render path calls it."""
    r, outs = _check_minarg_fused(rays8, tri_pack, sub,
                                  "minarg_fused_counted")
    if rays8.device.type != "cuda":
        raise ValueError("minarg_fused_counted runs on CUDA tensors only")
    count = torch.zeros(5, dtype=torch.int64, device=rays8.device)
    _build.launch("minarg_fused_count", rays8, tri_pack, sub, *outs,
                  start_flags(r, rays8.device), r, tri_pack.shape[0],
                  MINARG_FUSED_COOP, count)
    return tuple(outs), tuple(int(x) for x in count.tolist())


def make_minarg_intersect(tris: TrianglesSoA, *, fuse_fetch: bool = False,
                          with_ids: bool = False):
    """The exact small-scene intersector: K1 min + argmin, then the K2
    attribute fetch. intersect(rays) -> Hits, or (Hits, ids) with ids
    the winner's triangle index (-1 on a miss) when with_ids=True.

    fuse_fetch=True runs K14, the two in one launch, for any table (the
    JAX package's one-tt-block limit is the TPU's VMEM; K14 here loops
    over the whole pack and gives K1 + K2's bits); on the card its table
    of the skip rule (`sub_boxes` over the one span [0, T)) is built once
    here."""
    if with_ids and fuse_fetch:
        raise ValueError("with_ids needs fuse_fetch=False (the fused "
                         "kernel never materializes the winner index)")
    tri_pack = build_tri_pack(tris)
    sub = (sub_boxes(tri_pack, [(0, tri_pack.shape[0])])
           if fuse_fetch and tri_pack.device.type == "cuda" else None)

    def intersect(rays: Rays):
        rays8 = pack_rays(rays.p, rays.d)
        if fuse_fetch:
            t, nx, ny, nz, m = minarg_fused(rays8, tri_pack, sub)
        else:
            t1, g1 = minarg(rays8, tri_pack)
            t, nx, ny, nz, m = refine1(t1, g1, tri_pack)
        any_hit = t > 0.0
        z = torch.zeros_like(t)
        safe_t = torch.where(any_hit, t, z)
        hit_p = tuple(torch.where(any_hit, rays.p[k] + rays.d[k] * safe_t, z)
                      for k in range(3))
        hits = Hits(t=t, p=hit_p, n=(nx, ny, nz),
                    mati=torch.where(any_hit, m, z).to(torch.int32))
        if not with_ids:
            return hits
        ids = torch.where(any_hit, g1, torch.full_like(g1, -1.0))
        return hits, ids.to(torch.int32)

    return intersect


# --- K13a / K13b: Plucker candidates and their exact refine ---------------
#
# The reference's three edge tests multiplied through by vn become
# Plucker inner products E_k = (m_k x n).(P x D) + (c0 m_k - d_k n).D,
# accepted when E_k sign(vn) >= 0. K13a evaluates them in bf16 (each
# operand split hi + lo, products hi.hi + hi.lo + lo.hi, summed in
# float32), loosened by a per-triangle bound eps_k on every error of that
# evaluation, so its accepted set is a superset of K1/K4's; t is K1's
# exact float32 expression. It keeps the two lexicographically smallest
# (t, index) candidates. K13b re-tests them with K1's exact test: the
# first that passes is K4's winner bit for bit; when both fail and a
# second candidate existed, a third might win, and the lane is PENDING
# (the fused pipeline's rotating exact slice resolves it).

EPS_SCALE = 2.0 ** -15
CAND_TILE = 64   # triangles per shared-memory tile of csrc/plucker_cand.cu


def _rne_bf16_bits(u):
    """Round-to-nearest-even float32 -> bf16 on uint32 bit patterns (numpy
    uint64 or torch int64 holding 0..2^32-1): the bf16 value's bits in
    the high half, the low half zero."""
    lsb = (u >> 16) & 1
    return (u + 0x7FFF + lsb) & 0xFFFF0000


def _bf16_np(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bf16 value (ties to even), as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return _rne_bf16_bits(u).astype(np.uint32).view(np.float32)


def _bf16_tensor_np(x: np.ndarray, device) -> torch.Tensor:
    """float32 numpy holding bf16 values -> a torch bfloat16 tensor."""
    bits = (np.ascontiguousarray(x, np.float32).view(np.uint32) >> 16)
    return torch.as_tensor(bits.astype(np.uint16).view(np.int16),
                           device=device).view(torch.bfloat16)


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _f32(u: torch.Tensor) -> torch.Tensor:
    """uint32 bit patterns in int64 -> float32."""
    return (u - ((u >> 31) << 32)).to(torch.int32).view(torch.float32)


def split_bf16_exact(x: torch.Tensor):
    """float32 -> (hi, lo) bfloat16 with hi = RNE(x) and lo = RNE(x - hi),
    in integer bit arithmetic (`_split_bf16_exact`)."""
    hi_u = _rne_bf16_bits(_u32(x))
    lo_u = _rne_bf16_bits(_u32(x - _f32(hi_u)))

    def bf16(u):
        b = u >> 16
        return (b - ((b >> 15) << 16)).to(torch.int16).view(torch.bfloat16)

    return bf16(hi_u), bf16(lo_u)


def plucker_feat(rays8: torch.Tensor) -> torch.Tensor:
    """(8, R) rays -> (32, R) bfloat16 features [phi_hi(6), phi_lo(6),
    phi_hi(6), 0(14)] with phi = [P x D, D], each product and difference
    rounded separately."""
    px, py, pz, dx, dy, dz = (rays8[k] for k in range(6))
    phi = torch.stack([py * dz - pz * dy, pz * dx - px * dz,
                       px * dy - py * dx, dx, dy, dz])
    hi, lo = split_bf16_exact(phi)
    zeros = torch.zeros((14, phi.shape[1]), dtype=torch.bfloat16,
                        device=phi.device)
    return torch.cat([hi, lo, hi, zeros])


def build_plucker_packs(tris: TrianglesSoA, *, chunk: int = 256,
                        tt: int = 1024, eps_scale: float = EPS_SCALE):
    """(trig bfloat16 (3 tpad, 32), tric float32 (tpad, 8), tpad), bit-equal
    to the JAX package's packs.

    trig: chunk-major rows [w1; w2; w3] per chunk of `chunk` triangles,
    columns [w_hi(6), w_hi(6), w_lo(6), 0] pairing with plucker_feat, with
    w_k = [m_k x n, c0 m_k - d_k n]. tric: [n(3), c0, eps1, eps2, eps3, 0]
    with eps_k = eps_scale |w_k|.Phi, Phi the feature bound over legal
    rays (|D| <= 1, |P x D| <= 2 |scene corner| + 1). Padding triangles
    have n = w = 0: t = 0/0 fails t > 0, so they never accept."""
    t = tris.count
    t8 = _round_up(t, 8) if t <= tt else _round_up(t, tt)
    tpad = _round_up(max(t8, chunk), chunk)
    tpad = _round_up(tpad, min(tt, tpad) if tpad >= tt else tpad)
    g = np.zeros((tpad, 17), np.float32)
    g[:t] = build_tri_pack(tris)[:, :17].cpu().numpy()
    n = g[:, 0:3].astype(np.float64)
    c0 = g[:, 3].astype(np.float64)
    pts = np.concatenate([tris.r1.cpu().numpy(), tris.r2.cpu().numpy(),
                          tris.r3.cpu().numpy()], axis=0)
    pmax = 2.0 * float(np.linalg.norm(pts, axis=1).max()) + 1.0
    phi_bound = np.array([pmax] * 3 + [1.01] * 3)

    trig = np.zeros((3 * tpad, 32), np.float32)
    tric = np.zeros((tpad, 8), np.float32)
    tric[:, 0:3] = n.astype(np.float32)
    tric[:, 3] = c0.astype(np.float32)
    w_all = []
    for k in range(3):
        m = g[:, 4 + 4 * k:7 + 4 * k].astype(np.float64)
        d = g[:, 7 + 4 * k].astype(np.float64)
        w = np.concatenate([np.cross(m, n), c0[:, None] * m - d[:, None] * n],
                           1).astype(np.float32)
        w_all.append(w)
        eps = eps_scale * (np.abs(w).astype(np.float64) @ phi_bound)
        live = np.abs(n).sum(1) > 0
        tric[:, 4 + k] = np.where(live, eps, 1e-30).astype(np.float32)
    for c0i in range(0, tpad, chunk):
        cc = min(chunk, tpad - c0i)
        for k in range(3):
            trig[3 * c0i + k * cc:3 * c0i + (k + 1) * cc, 0:6] = (
                w_all[k][c0i:c0i + cc])
    hi32 = _bf16_np(trig[:, 0:6])
    merged = np.zeros((3 * tpad, 32), np.float32)
    merged[:, 0:6] = hi32
    merged[:, 6:12] = hi32
    merged[:, 12:18] = trig[:, 0:6] - hi32
    dev = tris.device
    return (_bf16_tensor_np(_bf16_np(merged), dev),
            torch.as_tensor(tric, device=dev), tpad)


def _merge_top2(run, new):
    """Merge a running top-2 with a chunk's top-2 (each (t1, g1, t2, g2));
    ties go to the lower triangle index."""
    o1, og1, o2, og2 = run
    m1, gg1, m2, gg2 = new
    bet = (m1 < o1) | ((m1 == o1) & (gg1 < og1))
    n1, ng1 = torch.where(bet, m1, o1), torch.where(bet, gg1, og1)
    r, rg = torch.where(bet, o1, m1), torch.where(bet, og1, gg1)
    s, sg = torch.where(bet, m2, o2), torch.where(bet, gg2, og2)
    bet2 = (s < r) | ((s == r) & (sg < rg))
    return n1, ng1, torch.where(bet2, s, r), torch.where(bet2, sg, rg)


def candidates_plain(rays8: torch.Tensor, trig: torch.Tensor,
                     tric: torch.Tensor, chunk: int = 256,
                     ray_chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of K13a: a (4, R) float32 tensor of rows
    [t1, g1, t2, g2].

    Per chunk of `chunk` triangles: the first (t, index) minimum, then the
    minimum with that position masked to BIG (so a chunk with fewer than
    two accepts fills in (BIG, first index of the chunk)); chunks merge in
    order by _merge_top2. Each E_k sums its 18 exact bf16 products in two
    float32 accumulators, even and odd terms in order, then adds them:
    the order XLA's CPU dot takes, which the CUDA kernel repeats."""
    tpad = tric.shape[0]
    dev = rays8.device
    j = torch.arange(tpad, device=dev)
    base = (j // chunk) * (3 * chunk) + j % chunk
    w = [trig[base + k * chunk, :18].to(torch.float32)[:, :, None]
         for k in range(3)]                                # (T, 18, 1)
    col = [tric[:, k:k + 1] for k in range(8)]             # (T, 1)
    nch = tpad // chunk
    r = rays8.shape[1]
    out = torch.empty((4, r), dtype=torch.float32, device=dev)
    for s in range(0, r, ray_chunk):
        rays = rays8[:, s:s + ray_chunk]
        feat = plucker_feat(rays)[:18].to(torch.float32)   # (18, Rc)
        e = []
        for k in range(3):
            acc = [w[k][:, 0] * feat[0], w[k][:, 1] * feat[1]]
            for q in range(2, 18):
                acc[q % 2] = acc[q % 2] + w[k][:, q] * feat[q]
            e.append(acc[0] + acc[1])
        p = (rays[0:1], rays[1:2], rays[2:3])
        d = (rays[3:4], rays[4:5], rays[5:6])
        nrm = (col[0], col[1], col[2])
        vn = _dot3(nrm, d)
        t = (col[3] - _dot3(nrm, p)) / vn
        pos = vn > 0.0
        va = (e[0] >= -col[4]) & (e[1] >= -col[5]) & (e[2] >= -col[6])
        vb = (e[0] <= col[4]) & (e[1] <= col[5]) & (e[2] <= col[6])
        valid = ((pos & va) | (~pos & vb)) & (t > 0.0)
        tm = torch.where(valid, t, torch.full_like(t, BIG))
        tm = tm.view(nch, chunk, -1)
        m1, a1 = torch.min(tm, dim=1)                      # first on ties
        tm2 = tm.scatter(1, a1[:, None], BIG)
        m2, a2 = torch.min(tm2, dim=1)
        c0s = (torch.arange(nch, device=dev) * chunk)[:, None]
        g1 = (c0s + a1).to(torch.float32)
        g2 = (c0s + a2).to(torch.float32)
        run = (m1[0], g1[0], m2[0], g2[0])
        for c in range(1, nch):
            run = _merge_top2(run, (m1[c], g1[c], m2[c], g2[c]))
        out[:, s:s + ray_chunk] = torch.stack(run)
    return out


def _check_candidates(rays8, trig, tric, chunk, live=None):
    """Raise unless the arguments suit K13a's kernels (and the live
    count, where one is given, lies in 0..tpad)."""
    _build.check_rows(rays8, "rays8", 8)
    _build.check(tric, "tric", (None, 8))
    tpad = tric.shape[0]
    _build.check(trig, "trig", (3 * tpad, 32), dtype=torch.bfloat16)
    if not (rays8.device == trig.device == tric.device):
        raise ValueError("rays8, trig and tric must be on one device")
    if tpad == 0 or tpad % chunk or chunk % CAND_TILE or tpad >= 1 << 24:
        raise ValueError(f"candidates needs 0 < tpad < 2^24 with tpad a "
                         f"multiple of chunk and chunk of {CAND_TILE}; got "
                         f"tpad {tpad}, chunk {chunk}")
    if live is not None and not 0 <= live <= tpad:
        raise ValueError(f"candidates needs 0 <= live <= tpad ({tpad}); "
                         f"got live {live}")


def _launch_candidates(entry, rays8, trig, tric, chunk, *extra):
    r = rays8.shape[1]
    out = torch.empty((4, r), dtype=torch.float32, device=rays8.device)
    _build.launch(entry, rays8, rays8.stride(0), trig, tric, out, r,
                  tric.shape[0], *extra)
    return out


def candidates(rays8: torch.Tensor, trig: torch.Tensor, tric: torch.Tensor,
               chunk: int = 256, *, live: int) -> torch.Tensor:
    """K13a: (4, R) rows [t1, g1, t2, g2] for the (8, R) rays (rows
    contiguous each; a column slice is read in place) against the packs
    of build_plucker_packs. The features are computed inside the kernel.
    `live` is the scene's triangle count (`tris.count`): the rows at or
    above it are the packs' padding, which never accepts, and the kernel
    does not scan them. CPU tensors take the plain version
    (over every row: the same rows); CUDA tensors launch the kernel
    (`csrc/plucker_cand.cu`, the edge values on the tensor cores behind a
    certified margin) or raise."""
    _check_candidates(rays8, trig, tric, chunk, live)
    if rays8.device.type == "cpu":
        return candidates_plain(rays8, trig, tric, chunk)
    return _launch_candidates("plucker_cand", rays8, trig, tric, chunk,
                              live, chunk)


def run_candidates_simt(rays8: torch.Tensor, trig: torch.Tensor,
                        tric: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """K13a's first kernel (`csrc/plucker_cand.cu::plucker_cand_simt_kernel`,
    every product on the float32 cores, every row of the packs), on CUDA
    tensors: candidates' rows. For the checks only (the smoke and the
    cuda tests hold the tensor-core kernel against it and time the two in
    turns); no render path calls it."""
    _check_candidates(rays8, trig, tric, chunk)
    if rays8.device.type != "cuda":
        raise ValueError("run_candidates_simt runs on CUDA tensors only")
    return _launch_candidates("plucker_cand_simt", rays8, trig, tric, chunk,
                              chunk)


def candidates_counted(rays8: torch.Tensor, trig: torch.Tensor,
                       tric: torch.Tensor, chunk: int = 256, *,
                       live: int):
    """candidates' kernel on CUDA tensors, also counting the edge tests
    its margin sent to the float32 chain: ((4, R) rows, the count). For
    the checks only; no render path calls it."""
    _check_candidates(rays8, trig, tric, chunk, live)
    if rays8.device.type != "cuda":
        raise ValueError("candidates_counted runs on CUDA tensors only")
    count = torch.zeros(1, dtype=torch.int64, device=rays8.device)
    out = _launch_candidates("plucker_cand_count", rays8, trig, tric, chunk,
                             live, chunk, count)
    return out, int(count.item())


def refine_plain(rays8: torch.Tensor, cand: torch.Tensor,
                 tri_pack: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K13b: a (6, R) float32 tensor of rows
    [t, nx, ny, nz, mati, pending]. t = -1 on a confirmed miss and on a
    pending lane; the attributes are the chosen candidate's (the first's
    when neither passed), `+ 0.0` as the TPU's one-hot fetch gives them;
    a candidate index past the table reads a zero row (TPU padding)."""
    t1, g1, t2, g2 = cand
    n_tris = tri_pack.shape[0]
    p = (rays8[0], rays8[1], rays8[2])
    d = (rays8[3], rays8[4], rays8[5])

    def exact_valid(g):
        gi = g.long()
        inside = (gi >= 0) & (gi < n_tris)
        rows = tri_pack[gi.clamp(0, n_tris - 1), :17] + 0.0
        rows = torch.where(inside[:, None], rows, torch.zeros_like(rows))
        c = rows.t()

        def dots(b):
            v = (c[b], c[b + 1], c[b + 2])
            return _dot3(v, p), _dot3(v, d)

        pn, vn = dots(0)
        t = (c[3] - pn) / vn
        valid = t > 0.0
        for b in (4, 8, 12):
            pm, vm = dots(b)
            valid = valid & (fp.fma(t, vm, pm) >= c[b + 3])
        return valid, c

    has1, has2 = t1 < BIG, t2 < BIG
    v1, rows1 = exact_valid(g1)
    v2, rows2 = exact_valid(g2)
    v1, v2 = v1 & has1, v2 & has2
    use2 = ~v1 & v2
    miss = ~has1 | (~v1 & ~has2)
    pend = ~v1 & ~v2 & has2
    t = torch.where(miss | pend, torch.full_like(t1, -1.0),
                    torch.where(use2, t2, t1))
    pick = torch.where(use2, rows2, rows1)
    return torch.stack([t, pick[0], pick[1], pick[2], pick[16],
                        pend.to(torch.float32)])


def refine(rays8: torch.Tensor, cand: torch.Tensor,
           tri_pack: torch.Tensor) -> torch.Tensor:
    """K13b on K13a's (4, R) candidates: (6, R) rows [t, nx, ny, nz, mati,
    pending]. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    _build.check_rows(rays8, "rays8", 8)
    r = rays8.shape[1]
    _build.check(cand, "cand", (4, r))
    _build.check(tri_pack, "tri_pack", (None, TRI_COLS))
    if not (rays8.device == cand.device == tri_pack.device):
        raise ValueError("rays8, cand and tri_pack must be on one device")
    if tri_pack.shape[0] == 0:
        raise ValueError("refine needs at least one triangle")
    if rays8.device.type == "cpu":
        return refine_plain(rays8, cand, tri_pack)
    out = torch.empty((6, r), dtype=torch.float32, device=rays8.device)
    _build.launch("plucker_refine", rays8, rays8.stride(0), cand, tri_pack,
                  out, r, tri_pack.shape[0])
    return out


def make_plucker_intersect(tris: TrianglesSoA, *, tt: int = 1024,
                           chunk: int = 256):
    """intersect(rays) -> (Hits, pending bool): K13a then K13b. Hits are
    bit-identical to K4's (`make_pallas_intersect`) wherever pending is
    False; the caller resolves pending lanes. `intersect.rows(rays8)`
    gives the (6, R) rows [t, nx, ny, nz, mati, pending] straight off an
    (8, R) ray pack, as the fused pipeline reads them."""
    trig, tric, _ = build_plucker_packs(tris, chunk=chunk, tt=tt)
    tri_pack = build_tri_pack(tris)
    # The TPU fetches the refine's constants with a one-hot bf16 matmul
    # over a 3-way split of the table; the split is exact, so Hopper's
    # indexed load of the float32 row gives the same values.
    t17 = tri_pack[:, :17].cpu().numpy()
    hi = _bf16_np(t17)
    mid = _bf16_np(t17 - hi)
    lo = _bf16_np(t17 - hi - mid)
    if not (hi.astype(np.float64) + mid.astype(np.float64)
            + lo.astype(np.float64) == t17.astype(np.float64)).all():
        raise RuntimeError("bf16 3-way split failed to reconstruct the "
                           "float32 table exactly")

    def rows(rays8: torch.Tensor) -> torch.Tensor:
        return refine(rays8, candidates(rays8, trig, tric, chunk,
                                        live=tris.count), tri_pack)

    def intersect(rays: Rays):
        h = rows(pack_rays(rays.p, rays.d))
        hits = assemble_hits(rays, rays.count, h[0], h[1], h[2], h[3], h[4])
        return hits, h[5] > 0.0

    intersect.rows = rows
    return intersect
