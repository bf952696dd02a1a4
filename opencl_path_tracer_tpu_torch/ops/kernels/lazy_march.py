"""K20: the lazy march of the lazy-certification wavefront (CUDA kernel and
plain version).

Port of `opencl_path_tracer_tpu/ops/pallas/lazy_march.py`: the kernel
`_lazy_kernel` (launched by `run_lazy_march`, lazy_march.py:50-254) and
`unvisited_mask` (:257-264).

K20 is K18's grid (block b of tr sorted lanes visits the clusters
clist[b K : (b + 1) K], -1 a dummy) started from the six rows a lane
carries across steps (t, nx, ny, nz, mati, g), pend from 0, merging as
K18 (`march_kernel`). It also updates each lane's visited-cluster
bitmask: a real visit that did not leave the lane pending sets cluster
c's bit, bit c % 32 of word c // 32. The JAX package holds the mask as
(CW, N) uint32; the port holds the same bits as int32 (`torch.uint32`
lacks most kernels), and `interop` converts.
"""

from __future__ import annotations

import torch

from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.ops.kernels import march_kernel as mk
from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import _u32

MAX_CW = 32   # visited words a lane of csrc/lazy.cu keeps (C <= 1,024)


def lazy_plain(clist, rays8s, feat, rows0, vis, scene, cs: int, K: int,
               tr: int):
    """Plain PyTorch version of K20: ((7, N) rows, (CW, N) int32 mask)."""
    n = rays8s.shape[1]
    nb = n // tr
    vb = torch.arange(nb, device=clist.device).repeat_interleave(K)
    vc = clist.long()
    live = vc >= 0
    res = mk._visits_plain(rays8s, feat, scene, cs, tr, vb[live], vc[live])
    start = torch.cat([rows0, torch.zeros_like(rows0[:1])])
    out = mk._merge_plain(start, vb[live], *res, scene.tric, tr)
    # Visits of one list column touch distinct blocks, so each column's
    # (word, block) pairs are distinct and its bits OR in one assignment.
    words = _u32(vis).view(-1, nb, tr)
    col = torch.arange(vb.numel(), device=clist.device)[live] % K
    ok = ~res[3]
    cid = vc[live]
    bits = torch.where(ok, (1 << (cid % 32))[:, None],
                       torch.zeros_like(cid)[:, None])
    for u in range(K):
        m = col == u
        w, b = cid[m] // 32, vb[live][m]
        words[w, b] = words[w, b] | bits[m]
    words = words.view(-1, n)
    return out, (words - ((words >> 31) << 32)).to(torch.int32)


def _check_lazy(clist, rays8s, feat, best_rows, vis, scene, cs: int, K: int,
                tr: int, what: str) -> int:
    """Raise unless the inputs suit K20; returns its CW mask words."""
    c = mk.check_march_inputs(rays8s, feat, scene, cs, tr, what)
    n = rays8s.shape[1]
    _build.check(clist, "clist", (n // tr * K,), dtype=torch.int32)
    _build.check(best_rows, "best_rows", (6, n))
    cw = -(-c // 32)
    _build.check(vis, "vis", (cw, n), dtype=torch.int32)
    if not clist.device == best_rows.device == vis.device == rays8s.device:
        raise ValueError("clist, best_rows, vis and rays8s must be on one "
                         "device")
    if cw > MAX_CW:
        raise ValueError(f"{what} keeps at most {MAX_CW} visited "
                         f"words (C <= {32 * MAX_CW}); C is {c}")
    if clist.numel() and int(clist.max()) >= c:
        raise ValueError(f"clist names a cluster past C = {c}")
    return cw


def _launch(entry: str, clist, rays8s, feat, best_rows, vis, scene, cs: int,
            K: int, tr: int, cw: int, *extra):
    n = rays8s.shape[1]
    out = torch.empty((7, n), dtype=torch.float32, device=rays8s.device)
    vis_out = torch.empty_like(vis)
    if n:
        _build.launch(entry, clist, rays8s, feat, best_rows, vis, scene.trig,
                      scene.tric, out, vis_out, n, K, tr, cs, cw, *extra)
    return out, vis_out


def run_lazy_march(clist, rays8s, feat, best_rows, vis, scene, cs: int,
                   K: int, tr: int):
    """K20: ((7, N) rows [t nx ny nz mati g pend], (CW, N) int32 visited
    mask) for the sorted lanes rays8s (8, N) with features feat (32, N)
    bfloat16, the carried rows best_rows (6, N) and mask vis (CW, N)
    int32 (uint32 bits), block b visiting clist[b K : (b + 1) K]. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    cw = _check_lazy(clist, rays8s, feat, best_rows, vis, scene, cs, K, tr,
                     "run_lazy_march")
    if rays8s.device.type == "cpu":
        return lazy_plain(clist, rays8s, feat, best_rows, vis, scene, cs, K,
                          tr)
    return _launch("lazy_march", clist, rays8s, feat, best_rows, vis, scene,
                   cs, K, tr, cw)


def _check_cuda(clist, rays8s, feat, best_rows, vis, scene, cs, K, tr,
                what: str) -> int:
    cw = _check_lazy(clist, rays8s, feat, best_rows, vis, scene, cs, K, tr,
                     what)
    if rays8s.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors only")
    return cw


def run_lazy_march_simt(clist, rays8s, feat, best_rows, vis, scene, cs: int,
                        K: int, tr: int):
    """K20's first kernel (`csrc/lazy.cu::lazy_simt_kernel`: one lane per
    thread over march_visit.cuh, every product on the float32 cores), on
    CUDA tensors: run_lazy_march's outputs. For the checks only (the
    smoke and the cuda tests hold the new kernel against it on whole
    launches and time the two in turns); no render path calls it."""
    cw = _check_cuda(clist, rays8s, feat, best_rows, vis, scene, cs, K, tr,
                     "run_lazy_march_simt")
    return _launch("lazy_march_simt", clist, rays8s, feat, best_rows, vis,
                   scene, cs, K, tr, cw)


def run_lazy_march_counted(clist, rays8s, feat, best_rows, vis, scene,
                           cs: int, K: int, tr: int):
    """run_lazy_march's kernel on CUDA tensors, also counting the edge
    tests its margin sent to the float32 chain: (rows, mask, the count as
    an int). For the checks only; no render path calls it."""
    cw = _check_cuda(clist, rays8s, feat, best_rows, vis, scene, cs, K, tr,
                     "run_lazy_march_counted")
    count = torch.zeros(1, dtype=torch.int64, device=rays8s.device)
    out, vis_out = _launch("lazy_march_count", clist, rays8s, feat,
                           best_rows, vis, scene, cs, K, tr, cw, count)
    return out, vis_out, int(count.item())


def unvisited_mask(vis: torch.Tensor, C: int) -> torch.Tensor:
    """(CW, N) int32 bitmask -> (C, N) bool: cluster c NOT visited."""
    c = torch.arange(C, device=vis.device)
    return ((vis[c // 32] >> (c % 32).to(torch.int32)[:, None]) & 1) == 0
