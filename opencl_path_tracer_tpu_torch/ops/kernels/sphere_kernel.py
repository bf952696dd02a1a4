"""K3: nearest analytic-sphere hit (CUDA kernel and plain version).

Port of `opencl_path_tracer_tpu/ops/pallas/sphere_kernel.py`:
`_sphere_kernel` (launched by `_run_spheres`) and
`make_sphere_intersect`, for up to 64 spheres. The table form for more
spheres (`_sphere_table_kernel`) is not ported yet.

Per (ray, sphere), in the TPU kernel's order: b = p.d - d.c,
cc = p.p - 2 p.c + (c.c - r^2), disc = b^2 - cc, t = -b - sqrt(disc)
when that is > 0, else -b + sqrt(disc); a hit needs disc > 0 and t > 0.
A strict < across spheres keeps the lower index on ties. The outward
normal is (p + t d - c) / r, with 1/r and c.c - r^2 precomputed in
float32. On a miss t = -1 and the normal and material are 0.

XLA fuses multiply-adds in the interpret-mode reference; the plain
version applies `core.fp.fma` where it does, and the CUDA kernel
(`csrc/spheres.cu`) `__fmaf_rn`.
"""

from __future__ import annotations

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.core.spheres import SpheresSoA
from opencl_path_tracer_tpu_torch.core.types import Hits, Rays
from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    BIG, pack_rays,
)

MAX_SPHERES = 64
SPH_COLS = 8


def build_sphere_table(spheres: SpheresSoA) -> torch.Tensor:
    """(S, 8) float32 rows [cx cy cz rad 1/rad ccdot mati 0] with
    ccdot = c.c - r^2, computed in float32 like the TPU kernel's
    baked constants."""
    c = [np.asarray(x.cpu(), np.float32) for x in spheres.c]
    rad = np.asarray(spheres.rad.cpu(), np.float32)
    tab = np.zeros((spheres.count, SPH_COLS), np.float32)
    for k in range(3):
        tab[:, k] = c[k]
    tab[:, 3] = rad
    tab[:, 4] = np.float32(1.0) / rad
    tab[:, 5] = (c[0] * c[0] + c[1] * c[1] + c[2] * c[2] - rad * rad)
    tab[:, 6] = np.asarray(spheres.mati.cpu(), np.float32)
    return torch.as_tensor(tab, device=spheres.rad.device)


def _dot3(a, b):
    return fp.fma(a[2], b[2], fp.fma(a[0], b[0], a[1] * b[1]))


def spheres_plain(rays8: torch.Tensor, table: torch.Tensor):
    """Plain PyTorch version of K3: (t, nx, ny, nz, m), (R,) float32."""
    p = (rays8[0], rays8[1], rays8[2])
    d = (rays8[3], rays8[4], rays8[5])
    p_dot_d = _dot3(p, d)
    p_dot_p = _dot3(p, p)
    best_t = torch.full_like(p_dot_d, BIG)
    bn = [torch.zeros_like(p_dot_d) for _ in range(3)]
    bm = torch.zeros_like(p_dot_d)
    for row in table.cpu().tolist():
        cx, cy, cz, _rad, inv_rad, ccdot, mati = row[:7]
        c = tuple(torch.tensor(v, dtype=torch.float32, device=rays8.device)
                  for v in (cx, cy, cz))
        b_half = p_dot_d - _dot3(d, c)
        cc = p_dot_p - 2.0 * _dot3(p, c) + ccdot
        disc = fp.fma(b_half, b_half, -cc)
        sq = fp.sqrt(torch.where(disc < 0.0, torch.zeros_like(disc), disc))
        t_near = -b_half - sq
        t_far = -b_half + sq
        t = torch.where(t_near > 0.0, t_near, t_far)
        better = (disc > 0.0) & (t > 0.0) & (t < best_t)
        for k in range(3):
            h = (fp.fma(d[k], t, p[k]) - c[k]) * inv_rad
            bn[k] = torch.where(better, h, bn[k])
        best_t = torch.where(better, t, best_t)
        bm = torch.where(better, torch.full_like(bm, mati), bm)
    t = torch.where(best_t < BIG, best_t, torch.full_like(best_t, -1.0))
    return (t, bn[0], bn[1], bn[2], bm)


def spheres(rays8: torch.Tensor, table: torch.Tensor):
    """K3 for the (8, R) ray pack against the (S, 8) sphere table. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _build.check(rays8, "rays8", (8, None))
    _build.check(table, "sphere table", (None, SPH_COLS))
    if rays8.device != table.device:
        raise ValueError("rays8 and the sphere table must be on one device")
    if not 0 < table.shape[0] <= MAX_SPHERES:
        raise NotImplementedError(
            f"{table.shape[0]} spheres: K3 takes 1 to {MAX_SPHERES}; the "
            "table kernel for more (K3b) is still to be ported (ROADMAP.md "
            "queue 2)")
    if rays8.device.type == "cpu":
        return spheres_plain(rays8, table)
    r = rays8.shape[1]
    outs = [torch.empty(r, dtype=torch.float32, device=rays8.device)
            for _ in range(5)]
    _build.launch("spheres", rays8, table, *outs, r, table.shape[0])
    return tuple(outs)


def make_sphere_intersect(sph: SpheresSoA):
    """intersect(rays) -> Hits over the analytic spheres (t = -1, p = 0,
    n = 0, mati = 0 on a miss)."""
    table = build_sphere_table(sph)

    def intersect(rays: Rays) -> Hits:
        t, nx, ny, nz, m = spheres(pack_rays(rays.p, rays.d), table)
        any_hit = t > 0.0
        z = torch.zeros_like(t)
        safe_t = torch.where(any_hit, t, z)
        hit_p = tuple(torch.where(any_hit, rays.p[k] + rays.d[k] * safe_t, z)
                      for k in range(3))
        return Hits(t=t, p=hit_p, n=(nx, ny, nz),
                    mati=torch.where(any_hit, m, z).to(torch.int32))

    return intersect
