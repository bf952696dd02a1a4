"""K19: the flat visit list of the 'flat' accel (CUDA kernel and plain
version), with the intersector around it.

Port of `opencl_path_tracer_tpu/ops/pallas/flat_march.py`: the visit
kernel `_flat_kernel` (launched by `_run_flat`, flat_march.py:83-271),
`_build_visit_list` (:274-315) and `make_flat_march_intersect`
(:318-456); its `_nearest_lists` (:459-465) is `march_kernel._block_lists`,
which the port calls directly.

Round 0 is K18 (`march_kernel.run_march`, after its K18m copy) over every
block's K0 nearest needed clusters. Round 1 lists, block after block,
every cluster some lane still needs under the round-0 bound that round 0
did not visit, plus one dummy visit per block, in a flat list of Vcap =
round_up(max(N vcap_frac, 4096), 256) visits; visits past Vcap are
dropped. K19 (`run_flat`) walks each block's segment of the list from
the round-0 rows (pend included) and merges as K18. A lane is resolved
unless it is pending, a cluster it needs made neither round's list, or
its block's dummy fell past Vcap; the dense tail (K4 over the reordered
triangles) takes the rest. The hits equal K4's over the reordered
triangles bit for bit. presorted=True skips the lane sort and unsort.

On the TPU the list sat in scalar memory and did not compile at 1080p;
on the card it lives in global memory, and a block with no visit under
Vcap (never written on the TPU) keeps its round-0 rows. The kernel runs
each block's segment in chunks of at most CHUNK real visits, the longest
segments' chunks first (`flat_chunks`, built on the device), and merges
the chunks as the visits merge, by the (t, g) minimum and pend's OR.
"""

from __future__ import annotations

import torch

from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.types import Rays
from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.ops.kernels import march_kernel as mk
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    BIG, _round_up, make_pallas_intersect, pack_rays,
)
from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
    plucker_feat,
)
from opencl_path_tracer_tpu_torch.utils import profiling

CHUNK = 32   # real visits per chunk of K19's work list (S; PERF.md)


def _build_visit_list(bu: torch.Tensor, vcap: int):
    """(C, B) bool block needs -> (vb, vc, vis1, overflow): (Vcap,) int32
    block ids (non-decreasing) and cluster ids (-1: dummy), the (C, B)
    visits that made the list, and the (B,) blocks whose dummy did not.
    Integer arithmetic only."""
    c, b = bu.shape
    dev = bu.device
    bi = bu.to(torch.int64)
    kb = bi.sum(dim=0)
    kb1 = kb + 1
    offs = torch.cumsum(kb1, 0) - kb1
    pos = offs[None, :] + torch.cumsum(bi, 0) - bi
    put = bu & (pos < vcap)
    flat_pos = torch.where(put, pos, vcap).reshape(-1)
    dpos = torch.clamp(offs + kb, max=vcap)
    vc = torch.full((vcap + 1,), -1, dtype=torch.int64, device=dev)
    vb = torch.zeros((vcap + 1,), dtype=torch.int64, device=dev)
    blocks = torch.arange(b, device=dev)
    # Slot vcap collects every dropped visit and is cut off below; the
    # slots under it are written once each.
    vb[dpos] = blocks
    vc[flat_pos] = torch.arange(c, device=dev)[:, None].expand(c, b).reshape(-1)
    vb[flat_pos] = blocks[None, :].expand(c, b).reshape(-1)
    vb, vc = vb[:vcap], vc[:vcap]
    used = min(int(offs[-1] + kb1[-1]), vcap)
    vb[used:] = b - 1
    vc[used:] = -1
    return (vb.to(torch.int32), vc.to(torch.int32), put,
            (offs + kb) >= vcap)


def flat_plain(vb, vc, rays8s, feat, rows0, scene, cs: int, tr: int):
    """Plain PyTorch version of K19: (7, N) rows merged from rows0 over
    the real visits of the list."""
    live = vc >= 0
    vbl, vcl = vb[live].long(), vc[live].long()
    res = mk._visits_plain(rays8s, feat, scene, cs, tr, vbl, vcl)
    return mk._merge_plain(rows0, vbl, *res, scene.tric, tr)


def flat_chunks(vb, vc, nb: int, chunk: int, *, longest_first: bool = True):
    """K19's work list over nb >= 1 tr-blocks: each block's real visits
    (vc >= 0) cut into chunks of at most `chunk`, the chunks of the
    blocks with the most real visits first (a stable sort: ties in block
    order; block order throughout with longest_first=False, for the
    smoke's measurement of what the order buys). Integer tensor
    operations on vb's device, no host read. Returns (items, vcr,
    counts): items (3, ceil(V / chunk) + nb) int32, per item its
    tr-block (-1: a surplus item, no work) and its range [first, end) of
    vcr; vcr (V,) int32, the real visits' clusters in list order (-1
    past them); counts (nb,) int64, each block's real visits."""
    dev, v = vc.device, vc.numel()
    live = vc >= 0
    rank = torch.cumsum(live, 0)
    # Real visits before each list position, and at each block's start.
    before = torch.cat([torch.zeros(1, dtype=rank.dtype, device=dev), rank])
    offs = torch.searchsorted(
        vb, torch.arange(nb + 1, dtype=vb.dtype, device=dev))
    ro = before[offs]
    counts = ro[1:] - ro[:-1]
    # Slot v collects the dummies and is cut off below.
    vcr = torch.full((v + 1,), -1, dtype=torch.int32, device=dev)
    vcr[torch.where(live, rank - 1, v)] = vc
    nch = (counts + chunk - 1) // chunk
    order = (torch.sort(counts, descending=True, stable=True).indices
             if longest_first else torch.arange(nb, device=dev))
    ns = nch[order]
    cum = torch.cumsum(ns, 0)
    j = torch.arange(-(-v // chunk) + nb, device=dev)
    k = torch.searchsorted(cum, j, right=True)
    real = k < nb
    k = k.clamp(max=nb - 1)
    blk = order[k]
    first = ro[blk] + (j - cum[k] + ns[k]) * chunk
    end = torch.minimum(first + chunk, ro[blk + 1])
    items = torch.stack([torch.where(real, blk, -1),
                         torch.where(real, first, 0),
                         torch.where(real, end, 0)]).to(torch.int32)
    return items.contiguous(), vcr[:v], counts


def _check_flat(vb, vc, rays8s, feat, rows0, scene, cs: int, tr: int,
                what: str) -> int:
    """Raise unless the tensors suit K19 (no host read); returns C."""
    c = mk.check_march_inputs(rays8s, feat, scene, cs, tr, what)
    _build.check(vb, "vb", (None,), dtype=torch.int32)
    _build.check(vc, "vc", vb.shape, dtype=torch.int32)
    _build.check(rows0, "rows0", (7, rays8s.shape[1]))
    if not vb.device == vc.device == rows0.device == rays8s.device:
        raise ValueError("vb, vc, rows0 and rays8s must be on one device")
    return c


def _check_list(vb, vc, c: int, nb: int, what: str) -> None:
    """Raise unless vb holds non-decreasing block ids below nb and vc
    cluster ids below c (one host read)."""
    if vb.numel() and bool((vc.max() >= c) | (vb.min() < 0) | (vb.max() >= nb)
                           | (vb[1:] < vb[:-1]).any()):
        raise ValueError(f"{what} needs vb non-decreasing block ids and vc "
                         f"cluster ids below C = {c}")


def _launch_chunks(entry: str, vb, vc, rays8s, feat, rows0, scene, cs: int,
                   tr: int, chunk: int, *extra,
                   longest_first: bool = True) -> torch.Tensor:
    c = _check_flat(vb, vc, rays8s, feat, rows0, scene, cs, tr, entry)
    if rays8s.device.type != "cuda":
        raise ValueError(f"{entry} runs on CUDA tensors only")
    n = rays8s.shape[1]
    dev = rays8s.device
    out = torch.empty((7, n), dtype=torch.float32, device=dev)
    if not n:
        return out
    # The work list and the chunks' merged (t, g) bits (all ones: no chunk
    # beat rows0) and pend flags, queued before the list's check waits for
    # the card (the list's indices stay in bounds whatever vb holds).
    items, vcr, _ = flat_chunks(vb, vc, n // tr, chunk,
                                longest_first=longest_first)
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    pend = torch.zeros((n,), dtype=torch.int32, device=dev)
    _check_list(vb, vc, c, n // tr, entry)
    _build.launch(entry, items, items.shape[1], vcr, rays8s, feat, rows0,
                  scene.trig, scene.tric, best, pend, out, n, tr, cs, *extra)
    return out


def run_flat(vb, vc, rays8s, feat, rows0, scene, cs: int, tr: int):
    """K19: (7, N) float32 rows [t nx ny nz mati g pend] after the visits
    (vb, vc) ((V,) int32 each, vb non-decreasing, vc = -1 a dummy) of the
    sorted lanes rays8s (8, N) with features feat (32, N) bfloat16,
    starting from rows0 (7, N). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if rays8s.device.type == "cpu":
        c = _check_flat(vb, vc, rays8s, feat, rows0, scene, cs, tr,
                        "run_flat")
        _check_list(vb, vc, c, rays8s.shape[1] // tr, "run_flat")
        return flat_plain(vb, vc, rays8s, feat, rows0, scene, cs, tr)
    return _launch_chunks("flat_march", vb, vc, rays8s, feat, rows0, scene,
                          cs, tr, CHUNK)


def run_flat_simt(vb, vc, rays8s, feat, rows0, scene, cs: int, tr: int):
    """K19's first kernel (`csrc/flat.cu::flat_simt_kernel`: one CUDA
    block per 128 lanes walking its whole segment, every product on the
    float32 cores), on CUDA tensors: run_flat's rows. For the checks only
    (the smoke and the cuda tests hold the new kernel against it on whole
    launches and time the two in turns); no render path calls it."""
    c = _check_flat(vb, vc, rays8s, feat, rows0, scene, cs, tr,
                    "run_flat_simt")
    if rays8s.device.type != "cuda":
        raise ValueError("run_flat_simt runs on CUDA tensors only")
    n = rays8s.shape[1]
    _check_list(vb, vc, c, n // tr, "run_flat_simt")
    offs = torch.searchsorted(
        vb, torch.arange(n // tr + 1, dtype=torch.int32,
                         device=vb.device)).to(torch.int32)
    out = torch.empty((7, n), dtype=torch.float32, device=rays8s.device)
    if n:
        _build.launch("flat_march_simt", offs, vc, rays8s, feat, rows0,
                      scene.trig, scene.tric, out, n, tr, cs)
    return out


def run_flat_counted(vb, vc, rays8s, feat, rows0, scene, cs: int, tr: int,
                     chunk: int = CHUNK):
    """run_flat's kernel on CUDA tensors with chunks of `chunk` real
    visits, also counting the edge tests its margin sent to the float32
    chain: ((7, N) rows, the count as an int). For the checks only; no
    render path calls it."""
    count = torch.zeros(1, dtype=torch.int64, device=rays8s.device)
    out = _launch_chunks("flat_march_count", vb, vc, rays8s, feat, rows0,
                         scene, cs, tr, chunk, count)
    return out, int(count.item())


def make_flat_march_intersect(tris: TrianglesSoA, *, cs: int = 256,
                              tr: int = 256, K0: int = 4,
                              vcap_frac: float = 0.25, tail: int = 16384,
                              presorted: bool = False):
    """(intersect(rays) -> Hits, reordered triangles): the 'flat' accel
    (see the module docstring). While the recorder is on
    (`utils.profiling`) each call counts flat.calls, flat.lanes and
    flat.tail_iterations, and inside tracing(device_counts=True)
    flat.round1_resolved, flat.visits, flat.overflow_blocks,
    flat.tail_lanes and flat.pending."""
    scene, rt, c = mk.build_march_scene(tris, cs)
    tail_isect = make_pallas_intersect(rt)

    def intersect(rays: Rays):
        rpad = _round_up(rays.count, tr)
        rays8s = pack_rays(rays.p, rays.d, rpad)
        order_l = None
        if not presorted:
            order_l = torch.sort(mk.lane_key(rays8s[0:3], rays8s[3:6], scene),
                                 stable=True).indices
            rays8s = rays8s[:, order_l]
        feat = plucker_feat(rays8s)
        b = rpad // tr

        # Round 0: every block's K0 nearest needed clusters (K18).
        ent, need = mk._slab_entries(
            rays8s, scene, torch.full((rpad,), BIG, device=rays8s.device))
        clist0, r8m, fm = mk.materialize(mk._block_lists(ent, need, tr, K0),
                                         rays8s, feat)
        vis0 = mk._visited_from(clist0, c, K0)
        outs0 = mk.run_march(clist0, r8m, fm, scene, cs, K0, tr)

        # Round 1: the flat list of the clusters still needed (K19).
        need1 = mk._need(ent, outs0[0]).view(c, b, tr)
        del ent, need
        bu = need1.any(dim=2) & ~vis0
        vcap = _round_up(max(int(rpad * vcap_frac), 4096), 256)
        vb, vc, vis1, ovf = _build_visit_list(bu, vcap)
        outs1 = run_flat(vb, vc, r8m, fm, outs0, scene, cs, tr)
        best = list(outs1[:6].clone())
        pend = outs1[6] > 0.0

        # Certification: pending, a needed cluster in neither list, or a
        # block whose dummy fell past Vcap.
        unc = (need1 & (~vis0 & ~vis1)[:, :, None]).any(dim=0).reshape(-1)
        del need1
        res = ~(unc | pend | ovf.repeat_interleave(tr))
        res_pre_tail = res.clone()
        iters, lanes = mk.dense_tail(best, res, rays8s, tail_isect,
                                     min(tail, rpad))
        profiling.count("flat.calls")
        profiling.count("flat.lanes", rpad)
        profiling.count("flat.tail_iterations", iters)
        if profiling.device_counts():
            profiling.count("flat.round1_resolved", int(res_pre_tail.sum()))
            profiling.count("flat.visits", int((vc >= 0).sum()))
            profiling.count("flat.overflow_blocks", int(ovf.sum()))
            profiling.count("flat.tail_lanes", lanes)
            profiling.count("flat.pending", int(pend.sum()))
        return mk.unsort_hits(rays, best, order_l)

    return intersect, rt
