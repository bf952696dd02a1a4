"""Ray-scene intersection, plain PyTorch.

Port of `opencl_path_tracer_tpu/ops/intersect.py`: `first_intersect_ids`,
`first_intersect`, `sphere_intersect` and `merge_hits`. The brute-force
intersectors here are the plain versions of the K1/K2 and K3 kernels
(`ops/kernels/`), so they round exactly as the kernels do; they never
launch a kernel and serve the CPU ('bruteforce' accel) and the tests.
"""

from __future__ import annotations

import torch

from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.spheres import SpheresSoA
from opencl_path_tracer_tpu_torch.core.types import Hits, Rays
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    BIG, build_tri_pack, minarg_plain, pack_rays,
)
from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
    refine1_plain,
)
from opencl_path_tracer_tpu_torch.ops.kernels.sphere_kernel import (
    build_sphere_table, spheres_plain,
)


def _assemble(rays: Rays, t, n, m) -> Hits:
    any_hit = t > 0.0
    z = torch.zeros_like(t)
    safe_t = torch.where(any_hit, t, z)
    return Hits(
        t=torch.where(any_hit, t, torch.full_like(t, -1.0)),
        p=tuple(torch.where(any_hit, rays.p[k] + rays.d[k] * safe_t, z)
                for k in range(3)),
        n=tuple(torch.where(any_hit, c, z) for c in n),
        mati=torch.where(any_hit, m, z).to(torch.int32),
    )


def first_intersect_ids(rays: Rays,
                        tris: TrianglesSoA) -> tuple[Hits, torch.Tensor]:
    """Nearest hit over all triangles (prog.cl:113-122; the lowest index
    wins ties) plus the winner's index (-1 on a miss)."""
    pack = build_tri_pack(tris)
    t1, g1 = minarg_plain(pack_rays(rays.p, rays.d), pack)
    t, nx, ny, nz, m = refine1_plain(t1, g1, pack)
    hits = _assemble(rays, t, (nx, ny, nz), m)
    ids = torch.where(t1 < BIG, g1, torch.full_like(g1, -1.0))
    return hits, ids.to(torch.int32)


def first_intersect(rays: Rays, tris: TrianglesSoA) -> Hits:
    """Nearest hit of each ray against all triangles (brute force)."""
    return first_intersect_ids(rays, tris)[0]


def sphere_intersect(rays: Rays, spheres: SpheresSoA) -> Hits:
    """Nearest hit against all analytic spheres (outward normals; t = -1,
    p = n = 0, mati = 0 on a miss). Directions must be unit length."""
    t, nx, ny, nz, m = spheres_plain(pack_rays(rays.p, rays.d),
                                     build_sphere_table(spheres))
    return _assemble(rays, t, (nx, ny, nz), m)


def merge_hits(a: Hits, b: Hits) -> Hits:
    """Nearer valid hit of two streams; ties keep `a` (callers put the
    triangle stream first)."""
    b_wins = b.valid & (~a.valid | (b.t < a.t))

    def sel(x, y):
        return torch.where(b_wins, y, x)

    return Hits(
        t=sel(a.t, b.t),
        p=tuple(sel(x, y) for x, y in zip(a.p, b.p)),
        n=tuple(sel(x, y) for x, y in zip(a.n, b.n)),
        mati=sel(a.mati, b.mati),
    )


def hits_of(res) -> Hits:
    """The Hits of an intersector's result: Hits, or a textured
    intersector's (Hits, kd_scale) tuple."""
    return res[0] if isinstance(res, tuple) else res
