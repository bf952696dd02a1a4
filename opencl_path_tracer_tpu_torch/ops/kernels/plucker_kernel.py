"""K2: attributes of the K1 winner (CUDA kernel and plain version), and
the minarg intersector that chains K1 and K2.

Port of `opencl_path_tracer_tpu/ops/pallas/plucker_kernel.py`:
`_refine1_kernel` (launched by `_run_refine1`) and
`make_minarg_intersect`.

On the TPU the winner's normal and material come out of a one-hot
matmul over a bf16 three-way split of the triangle table; the split is
exact, so the fetch returns the float32 constants bit for bit, except
that the one-hot sum turns a -0.0 into +0.0. On Hopper the fetch is an
indexed load, with `+ 0.0` reproducing the sign of zero. On a miss
(t1 >= BIG) t = -1; the normal and material then belong to triangle 0,
as on the TPU (the callers mask them).
"""

from __future__ import annotations

import torch

from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.types import Hits, Rays
from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    BIG, TRI_COLS, build_tri_pack, minarg, pack_rays,
)


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


def make_minarg_intersect(tris: TrianglesSoA, *, with_ids: bool = False):
    """The exact small-scene intersector: K1 min + argmin, then the K2
    attribute fetch. intersect(rays) -> Hits, or (Hits, ids) with ids
    the winner's triangle index (-1 on a miss) when with_ids=True."""
    tri_pack = build_tri_pack(tris)

    def intersect(rays: Rays):
        rays8 = pack_rays(rays.p, rays.d)
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
