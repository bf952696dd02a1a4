"""The cluster-ordered scene packs of the pair intersector.

Port of `MarchScene` and `build_march_scene` of
`opencl_path_tracer_tpu/ops/pallas/march_kernel.py` (march_kernel.py:
91-229), in numpy on the host, bit-equal to the JAX package's packs.
The march kernels themselves (K18, K18m) are not ported yet.

The triangles are put in Morton order of their centroids, scene-spanning
ones (bounding-box diagonal above a quarter of the scene's) first, and
cut into clusters of `cs`; every pack is in that cluster-major order:

* trig: (3 T', 32) bf16 Plucker rows, chunk = cs, so cluster k's edge e
  rows are [3 k cs + e cs, 3 k cs + (e + 1) cs) (`build_plucker_packs`);
* tric: (T', 24) float32, the triangle pack's 17 constants with the
  per-lane eps terms in columns 17-22: edge k is accepted by the pair
  kernel when E_k >= -(col(17 + k) m + col(20 + k)), m the lane's
  max |P x D|;
* boxes_lo, boxes_hi: (C, 3) float32 cluster boxes, inflated by
  1e-4 diag + 1e-3 so a hit on a hull triangle is never lost to the slab
  test's rounding.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.accel.lbvh import morton3
from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    build_tri_pack,
)
from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
    EPS_SCALE, _bf16_np, _bf16_tensor_np, build_plucker_packs,
)


@dataclasses.dataclass(frozen=True)
class MarchScene:
    """Cluster-ordered scene constants (see the module docstring)."""

    trig: torch.Tensor      # (3 T', 32) bfloat16
    tric: torch.Tensor      # (T', 24) float32
    boxes_lo: torch.Tensor  # (C, 3) float32
    boxes_hi: torch.Tensor  # (C, 3) float32


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
                       boxes_hi=f32(bhi))
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
