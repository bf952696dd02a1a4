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
Vcap (never written on the TPU) keeps its round-0 rows.
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


def run_flat(vb, vc, rays8s, feat, rows0, scene, cs: int, tr: int):
    """K19: (7, N) float32 rows [t nx ny nz mati g pend] after the visits
    (vb, vc) ((V,) int32 each, vb non-decreasing, vc = -1 a dummy) of the
    sorted lanes rays8s (8, N) with features feat (32, N) bfloat16,
    starting from rows0 (7, N). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    c = mk.check_march_inputs(rays8s, feat, scene, cs, tr, "run_flat")
    n = rays8s.shape[1]
    _build.check(vb, "vb", (None,), dtype=torch.int32)
    _build.check(vc, "vc", vb.shape, dtype=torch.int32)
    _build.check(rows0, "rows0", (7, n))
    if not vb.device == vc.device == rows0.device == rays8s.device:
        raise ValueError("vb, vc, rows0 and rays8s must be on one device")
    if vb.numel() and (int(vc.max()) >= c or int(vb.min()) < 0
                       or int(vb.max()) >= n // tr
                       or bool((vb[1:] < vb[:-1]).any())):
        raise ValueError("run_flat needs vb non-decreasing block ids and vc "
                         f"cluster ids below C = {c}")
    if rays8s.device.type == "cpu":
        return flat_plain(vb, vc, rays8s, feat, rows0, scene, cs, tr)
    # Block b's visits: [offs[b], offs[b + 1]).
    offs = torch.searchsorted(
        vb, torch.arange(n // tr + 1, dtype=torch.int32,
                         device=vb.device)).to(torch.int32)
    out = torch.empty((7, n), dtype=torch.float32, device=rays8s.device)
    if n:
        _build.launch("flat_march", offs, vc, rays8s, feat, rows0,
                      scene.trig, scene.tric, out, n, tr, cs)
    return out


def make_flat_march_intersect(tris: TrianglesSoA, *, cs: int = 256,
                              tr: int = 256, K0: int = 4,
                              vcap_frac: float = 0.25, tail: int = 16384,
                              presorted: bool = False):
    """(intersect(rays) -> Hits, reordered triangles): the 'flat' accel
    (see the module docstring)."""
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
        if mk.STATS is not None:
            mk.STATS.append({"lanes": rpad,
                             "round1_resolved": int(res_pre_tail.sum()),
                             "visits": int((vc >= 0).sum()),
                             "overflow_blocks": int(ovf.sum()),
                             "tail_lanes": lanes, "tail_iterations": iters,
                             "pending": int(pend.sum())})
        return mk.unsort_hits(rays, best, order_l)

    return intersect, rt
