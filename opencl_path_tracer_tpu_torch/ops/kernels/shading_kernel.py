"""K8: the smooth refine, K1's winner with an interpolated vertex normal
(CUDA kernel and plain version), and the intersector that chains K1 and
K8.

Port of `opencl_path_tracer_tpu/ops/pallas/shading_kernel.py`:
`build_shading_pack`, `_smooth_refine_kernel` (launched by
`_run_smooth_refine`) and `make_smooth_minarg_intersect`.

K8 takes K2's place after K1's (t, g): it fetches the winner's face row
(normal, material) and its 17-column shading row (gu, gv, u0, v0, n1,
n2, n3; `ops/shading.py`), and computes

    p = o + d where(hit, t, 0)
    u = p.gu + u0,  v = p.gv + v0,  w = 1 - u - v
    n = normalize(w n1 + u n2 + v n3)

falling back to the face normal on a miss or where |n|^2 <= 1e-12
(triangles without vertex normals). On the TPU both rows come out of
one one-hot matmul over bf16 three-way splits, which sum to the float32
values exactly, so the fetch here is an indexed load of both rows, with
`+ 0.0` because the one-hot sum turns -0.0 into +0.0. On a miss
(t1 >= BIG) t = -1, and the normal and material are triangle 0's, as
K1's miss index is 0.

The reference values come from the Pallas kernel in interpret mode on
the CPU, where XLA contracts p = o + d t, each dot product's first two
terms and each blend's first two terms into fused multiply-adds; the
plain version does the same with `core.fp.fma`, the CUDA kernel
(`csrc/smooth_refine.cu`) with `__fmaf_rn`. XLA's CPU `rsqrt` is an
approximation; both versions here divide by a correctly rounded square
root, so a smooth normal can differ from the interpret-mode kernel's by
an ulp or two of its unit length, while t, the material, the fallback
normals and the unnormalised blend are bit-equal.
"""

from __future__ import annotations

import torch

from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.types import Hits, Rays
from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    BIG, TRI_COLS, assemble_hits, build_tri_pack, minarg, pack_rays,
)
from opencl_path_tracer_tpu_torch.ops.shading import PACK_COLS, VertexAttribs


def build_shading_pack(attribs: VertexAttribs) -> torch.Tensor:
    """(T, 17) float32 rows [gu gv u0 v0 n1 n2 n3], contiguous."""
    return attribs.packed.contiguous()


def _dot4(p, s, base, off):
    """dot(p, s[base:base+3]) + s[off] with XLA's contraction."""
    return fp.fma(p[2], s[:, base + 2],
                  fp.fma(p[0], s[:, base], p[1] * s[:, base + 1])) \
        + s[:, off]


def smooth_refine_plain(rays8: torch.Tensor, t1: torch.Tensor,
                        g1: torch.Tensor, tri_pack: torch.Tensor,
                        shading_pack: torch.Tensor):
    """Plain PyTorch version of K8: (t, nx, ny, nz, m), (R,) float32."""
    g = g1.long()
    rows = tri_pack[g] + 0.0
    s = shading_pack[g] + 0.0
    hit = t1 < BIG
    safe_t = torch.where(hit, t1, torch.zeros_like(t1))
    p = tuple(fp.fma(rays8[3 + k], safe_t, rays8[k]) for k in range(3))
    u = _dot4(p, s, 0, 6)
    v = _dot4(p, s, 3, 7)
    w = 1.0 - u - v
    ns = tuple(fp.fma(v, s[:, 14 + k], fp.fma(w, s[:, 8 + k],
                                               u * s[:, 11 + k]))
               for k in range(3))
    nn2 = fp.fma(ns[2], ns[2], fp.fma(ns[0], ns[0], ns[1] * ns[1]))
    big = nn2 > 1e-12
    use = hit & big
    inv = torch.reciprocal(fp.sqrt(torch.where(big, nn2,
                                               torch.ones_like(nn2))))
    t = torch.where(hit, t1, torch.full_like(t1, -1.0))
    n = tuple(torch.where(use, ns[k] * inv, rows[:, k])
              for k in range(3))
    return (t,) + n + (rows[:, 16],)


def smooth_refine(rays8: torch.Tensor, t1: torch.Tensor, g1: torch.Tensor,
                  tri_pack: torch.Tensor, shading_pack: torch.Tensor):
    """K8 on K1's (t, g) for the rays of the (8, R) pack, against the
    (T, 24) triangle pack and the (T, 17) shading pack: (t, nx, ny, nz,
    m), five (R,) float32 tensors. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    _build.check(rays8, "rays8", (8, None))
    r = rays8.shape[1]
    _build.check(t1, "t1", (r,))
    _build.check(g1, "g1", (r,))
    _build.check(tri_pack, "tri_pack", (None, TRI_COLS))
    n_tris = tri_pack.shape[0]
    _build.check(shading_pack, "shading_pack", (n_tris, PACK_COLS))
    if not all(x.device == rays8.device
               for x in (t1, g1, tri_pack, shading_pack)):
        raise ValueError("rays8, t1, g1, tri_pack and shading_pack must be "
                         "on one device")
    if n_tris == 0:
        raise ValueError("smooth_refine needs at least one triangle")
    if rays8.device.type == "cpu":
        return smooth_refine_plain(rays8, t1, g1, tri_pack, shading_pack)
    outs = [torch.empty(r, dtype=torch.float32, device=rays8.device)
            for _ in range(5)]
    _build.launch("smooth_refine", rays8, t1, g1, tri_pack, shading_pack,
                  *outs, r, n_tris)
    return tuple(outs)


def make_smooth_minarg_intersect(tris: TrianglesSoA,
                                 attribs: VertexAttribs):
    """The smooth-shading minarg intersector: K1 as
    `make_minarg_intersect` runs it, then K8 in place of K2.
    intersect(rays) -> Hits whose n is the interpolated vertex normal
    (the face normal on a miss or where the triangle has none)."""
    if attribs.count != tris.count:
        raise ValueError(f"attribs cover {attribs.count} triangles, scene "
                         f"has {tris.count}")
    tri_pack = build_tri_pack(tris)
    shading_pack = build_shading_pack(attribs)

    def intersect(rays: Rays) -> Hits:
        rays8 = pack_rays(rays.p, rays.d)
        t1, g1 = minarg(rays8, tri_pack)
        outs = smooth_refine(rays8, t1, g1, tri_pack, shading_pack)
        return assemble_hits(rays, rays.count, *outs)

    return intersect
