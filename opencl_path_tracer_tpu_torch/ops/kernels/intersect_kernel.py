"""K1: nearest triangle hit, min + argmin (CUDA kernel and plain version).

Port of `opencl_path_tracer_tpu/ops/pallas/intersect_kernel.py`:
`_minarg_kernel` (launched by `_run_minarg`), with the ray and triangle
packs it reads (`pack_rays`, `build_tri_pack`).

For each ray, over all triangles: t = (c0 - dot(P, n)) / dot(D, n),
accepted when t > 0 and dot(P, m_k) + t dot(D, m_k) >= d_k for the three
edges (prog.cl:94-112 in the m_k form of `core/geometry.py`). Outputs
the least accepted t (BIG on a miss) and the lowest index that reaches
it, as float32 (exact up to 2^24 triangles).

The reference values come from the Pallas kernel run in interpret mode
on the CPU, where XLA fuses each dot product's first two terms and each
edge test's `t * vm + pm` into fused multiply-adds; the plain version
does the same with `core.fp.fma`, and the CUDA kernel
(`csrc/minarg.cu`) with `__fmaf_rn`.
"""

from __future__ import annotations

import torch

from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.ops.kernels import _build

BIG = 3.0e38
TRI_COLS = 24


def pack_rays(p, d) -> torch.Tensor:
    """(8, R) float32 rows [px py pz dx dy dz 0 0]."""
    z = torch.zeros_like(p[0])
    return torch.stack([p[0], p[1], p[2], d[0], d[1], d[2], z, z])


def build_tri_pack(tris: TrianglesSoA) -> torch.Tensor:
    """(T, 24) float32 rows [n c0 m1 d1 m2 d2 m3 d3 mati 0*7]."""
    t = tris.count
    return torch.cat([
        tris.n, tris.c0[:, None], tris.m1, tris.d1[:, None],
        tris.m2, tris.d2[:, None], tris.m3, tris.d3[:, None],
        tris.mati.to(torch.float32)[:, None],
        torch.zeros((t, 7), dtype=torch.float32, device=tris.device),
    ], dim=1).contiguous()


def _dot3(v, a):
    """dot(v, a) with XLA's contraction: fma(v2, a2, fma(v0, a0, v1 a1))."""
    return fp.fma(v[2], a[2], fp.fma(v[0], a[0], v[1] * a[1]))


def minarg_plain(rays8: torch.Tensor, tri_pack: torch.Tensor,
                 ray_chunk: int = 8192):
    """Plain PyTorch version of K1: (t, g), two (R,) float32 tensors."""
    r = rays8.shape[1]
    t_out = torch.empty(r, dtype=torch.float32, device=rays8.device)
    g_out = torch.empty(r, dtype=torch.float32, device=rays8.device)
    c = tri_pack[:, :, None]                       # (T, 24, 1)

    def col(k):
        return c[:, k]                             # (T, 1)

    for s in range(0, r, ray_chunk):
        rays = rays8[:, s:s + ray_chunk]
        p = (rays[0:1], rays[1:2], rays[2:3])
        d = (rays[3:4], rays[4:5], rays[5:6])

        def dots(base):
            v = (col(base), col(base + 1), col(base + 2))
            return _dot3(v, p), _dot3(v, d)

        pn, vn = dots(0)
        t = (col(3) - pn) / vn                     # (T, Rc)
        valid = t > 0.0
        for base in (4, 8, 12):
            pm, vm = dots(base)
            valid &= fp.fma(t, vm, pm) >= col(base + 3)
        tm = torch.where(valid, t, torch.full_like(t, BIG))
        m, a = torch.min(tm, dim=0)                # first index on ties
        t_out[s:s + ray_chunk] = m
        g_out[s:s + ray_chunk] = a.to(torch.float32)
    return t_out, g_out


def minarg(rays8: torch.Tensor, tri_pack: torch.Tensor):
    """K1: (t, g) for each ray of the (8, R) pack against the (T, 24)
    triangle pack. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    _build.check(rays8, "rays8", (8, None))
    _build.check(tri_pack, "tri_pack", (None, TRI_COLS))
    if rays8.device != tri_pack.device:
        raise ValueError("rays8 and tri_pack must be on one device")
    if not 0 < tri_pack.shape[0] < 1 << 24:
        raise ValueError("minarg needs 1 to 2^24 - 1 triangles (the winner "
                         "index travels as an exact float32)")
    if rays8.device.type == "cpu":
        return minarg_plain(rays8, tri_pack)
    r = rays8.shape[1]
    t = torch.empty(r, dtype=torch.float32, device=rays8.device)
    g = torch.empty(r, dtype=torch.float32, device=rays8.device)
    _build.launch("minarg", rays8, tri_pack, t, g, r, tri_pack.shape[0])
    return t, g
