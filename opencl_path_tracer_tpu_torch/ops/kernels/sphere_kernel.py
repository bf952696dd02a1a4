"""K3 and K3b: nearest analytic-sphere hit (CUDA kernels and plain
versions).

Port of `opencl_path_tracer_tpu/ops/pallas/sphere_kernel.py`:
`_sphere_kernel` (launched by `_run_spheres`, up to 64 spheres),
`_sphere_table_kernel` (launched by `_run_sphere_table`, any count),
`make_sphere_intersect`, which sends more than 64 spheres to the table
kernel, and `make_sphere_table_intersect`.

Per (ray, sphere), in the TPU kernel's order: b = p.d - d.c,
cc = p.p - 2 p.c + (c.c - r^2), disc = b^2 - cc, t = -b - sqrt(disc)
when that is > 0, else -b + sqrt(disc); a hit needs disc > 0 and t > 0.
A strict < across spheres keeps the lower index on ties. The outward
normal is (p + t d - c) / r, with 1/r and c.c - r^2 precomputed in
float32. On a miss t = -1 and the normal and material are 0.

XLA fuses multiply-adds in the interpret-mode reference; the plain
versions apply `core.fp.fma` where it does, and the CUDA kernels
(`csrc/spheres.cu`, `csrc/sphere_table.cu`) `__fmaf_rn`. The JAX package
warns that its two kernels need not agree bit for bit, as XLA may
contract them differently; a probe of interpret-mode K3b on the CPU
(3,000 rays at the 66 spheres of `many_light_scene(64)`) found every
dot product fma(a2, b2, fma(a0, b0, a1 * b1)), disc = fma(b, b, -cc) and
p + t d = fma(d, t, p), which K3b's plain version and kernel use: t,
all three normal components and mati come out bit-equal. K3b fetches
the winner's row after the loop (the TPU's one-hot matmul, an indexed
load plus `+ 0.0` here).
"""

from __future__ import annotations

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.core.spheres import SpheresSoA
from opencl_path_tracer_tpu_torch.core.types import Hits, Rays
from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    BIG, assemble_hits, pack_rays,
)

MAX_SPHERES = 64
SPH_COLS = 8


def build_sphere_table(spheres: SpheresSoA) -> torch.Tensor:
    """(S, 8) float32 rows [cx cy cz rad 1/rad ccdot mati live] with
    ccdot = c.c - r^2, computed in float32 like the TPU kernels'
    constants, and live = 1 (K3b's table marks padding rows 0; K3
    ignores the column)."""
    c = [np.asarray(x.cpu(), np.float32) for x in spheres.c]
    rad = np.asarray(spheres.rad.cpu(), np.float32)
    tab = np.zeros((spheres.count, SPH_COLS), np.float32)
    for k in range(3):
        tab[:, k] = c[k]
    tab[:, 3] = rad
    tab[:, 4] = np.float32(1.0) / rad
    tab[:, 5] = (c[0] * c[0] + c[1] * c[1] + c[2] * c[2] - rad * rad)
    tab[:, 6] = np.asarray(spheres.mati.cpu(), np.float32)
    tab[:, 7] = 1.0
    return torch.as_tensor(tab, device=spheres.rad.device)


def _dot3(a, b):
    return fp.fma(a[2], b[2], fp.fma(a[0], b[0], a[1] * b[1]))


def spheres_plain(rays8: torch.Tensor, table: torch.Tensor):
    """Plain PyTorch version of K3: (t, nx, ny, nz, m), (R,) float32. K3
    keeps its best normal in the loop, K3b fetches the winner's row after
    it; the arithmetic and the tie rule are the same, so this is K3b's
    plain version."""
    return sphere_table_plain(rays8, table)


def spheres(rays8: torch.Tensor, table: torch.Tensor):
    """K3 for the (8, R) ray pack against the (S, 8) sphere table. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _build.check(rays8, "rays8", (8, None))
    _build.check(table, "sphere table", (None, SPH_COLS))
    if rays8.device != table.device:
        raise ValueError("rays8 and the sphere table must be on one device")
    if not 0 < table.shape[0] <= MAX_SPHERES:
        raise ValueError(
            f"{table.shape[0]} spheres: K3 takes 1 to {MAX_SPHERES}; "
            "make_sphere_intersect sends more to K3b (sphere_table)")
    if rays8.device.type == "cpu":
        return spheres_plain(rays8, table)
    r = rays8.shape[1]
    outs = [torch.empty(r, dtype=torch.float32, device=rays8.device)
            for _ in range(5)]
    _build.launch("spheres", rays8, table, *outs, r, table.shape[0])
    return tuple(outs)


def sphere_table_plain(rays8: torch.Tensor, table: torch.Tensor,
                       ray_chunk: int = 65536):
    """Plain PyTorch version of K3b: (t, nx, ny, nz, m), (R,) float32."""
    r = rays8.shape[1]
    outs = [torch.empty(r, dtype=torch.float32, device=rays8.device)
            for _ in range(5)]
    col = table[:, :, None]                          # (S, 8, 1)
    c = (col[:, 0], col[:, 1], col[:, 2])
    for s in range(0, r, ray_chunk):
        x = rays8[:, s:s + ray_chunk]
        p, d = (x[0], x[1], x[2]), (x[3], x[4], x[5])
        b_half = _dot3(p, d) - _dot3(d, c)           # (S, Rc)
        cc = (_dot3(p, p) - 2.0 * _dot3(p, c)) + col[:, 5]
        disc = fp.fma(b_half, b_half, -cc)
        sq = fp.sqrt(torch.clamp_min(disc, 0.0))
        t_near = -b_half - sq
        t = torch.where(t_near > 0.0, t_near, -b_half + sq)
        valid = (disc > 0.0) & (t > 0.0) & (col[:, 7] > 0.0)
        best_t, g = torch.min(torch.where(valid, t, torch.full_like(t, BIG)),
                              dim=0)                 # first index on ties
        hit = best_t < BIG
        row = table[g] + 0.0
        safe_t = torch.where(hit, best_t, torch.zeros_like(best_t))
        z = torch.zeros_like(best_t)
        outs[0][s:s + ray_chunk] = torch.where(hit, best_t,
                                               torch.full_like(z, -1.0))
        for k in range(3):
            n = (fp.fma(d[k], safe_t, p[k]) - row[:, k]) * row[:, 4]
            outs[1 + k][s:s + ray_chunk] = torch.where(hit, n, z)
        outs[4][s:s + ray_chunk] = torch.where(hit, row[:, 6], z)
    return tuple(outs)


def sphere_table(rays8: torch.Tensor, table: torch.Tensor):
    """K3b for the (8, R) ray pack against an (S, 8) sphere table of any
    size. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    _build.check(rays8, "rays8", (8, None))
    _build.check(table, "sphere table", (None, SPH_COLS))
    if rays8.device != table.device:
        raise ValueError("rays8 and the sphere table must be on one device")
    if table.shape[0] == 0:
        raise ValueError("K3b needs at least one sphere")
    if rays8.device.type == "cpu":
        return sphere_table_plain(rays8, table)
    r = rays8.shape[1]
    outs = [torch.empty(r, dtype=torch.float32, device=rays8.device)
            for _ in range(5)]
    _build.launch("sphere_table", rays8, table, *outs, r, table.shape[0])
    return tuple(outs)


def make_sphere_table_intersect(sph: SpheresSoA):
    """intersect(rays) -> Hits over the analytic spheres through K3b
    (t = -1, p = 0, n = 0, mati = 0 on a miss)."""
    table = build_sphere_table(sph)

    def intersect(rays: Rays) -> Hits:
        return assemble_hits(rays, rays.count,
                             *sphere_table(pack_rays(rays.p, rays.d), table))

    return intersect


def make_sphere_intersect(sph: SpheresSoA):
    """intersect(rays) -> Hits over the analytic spheres (t = -1, p = 0,
    n = 0, mati = 0 on a miss): K3 up to 64 spheres, K3b above, as the
    JAX package dispatches."""
    if sph.count > MAX_SPHERES:
        return make_sphere_table_intersect(sph)
    table = build_sphere_table(sph)

    def intersect(rays: Rays) -> Hits:
        return assemble_hits(rays, rays.count,
                             *spheres(pack_rays(rays.p, rays.d), table))

    return intersect
