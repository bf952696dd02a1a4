"""Ray-scene intersection, plain PyTorch.

Port of `opencl_path_tracer_tpu/ops/intersect.py`: `first_intersect_ids`,
`first_intersect`, `sphere_intersect` and `merge_hits`. The brute-force
intersectors here are the plain versions of the K1/K2 and K3 kernels
(`ops/kernels/`), so they round exactly as the kernels do; they never
launch a kernel and serve the CPU ('bruteforce' accel) and the tests.

`ray_tri_t` (all pairs, the reference's plane + edge-sign form),
`ray_tri_mt` (Moller-Trumbore, matched batches) and `intersect_aabb`
(the slab test) are the JAX module's test surface: no render path calls
them. They keep its IEEE behaviour: a parallel ray's inf or nan t, a
zero determinant's infinite inverse and a zero direction's infinite slab
distances all end in a miss or in the test's usual comparison, never in
a guard. `ray_tri_t` rounds its dot products as XLA's CPU backend
rounds `jnp.dot(..., Precision.HIGHEST)` of (R, 3) x (3, T): one
multiply, then two fused multiply-adds in k order (`core/fp.py::fma`).
"""

from __future__ import annotations

import torch

from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.spheres import SpheresSoA
from opencl_path_tracer_tpu_torch.core.types import (
    V3, Hits, Rays, vcross, vdot, vsub,
)
from opencl_path_tracer_tpu_torch.ops.kernels.cluster_kernel import (
    _xmax, _xmin,
)
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


def _dot_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(R, 3) x (3, T) -> (R, T): a @ b.T rounded as XLA's CPU dot,
    fma(a2, b2, fma(a1, b1, a0 * b0))."""
    ak = [a[:, k:k + 1] for k in range(3)]
    bk = [b[:, k][None, :] for k in range(3)]
    return fp.fma(ak[2], bk[2], fp.fma(ak[1], bk[1], ak[0] * bk[0]))


def ray_tri_t(p: torch.Tensor, d: torch.Tensor, tris: TrianglesSoA):
    """Hit distances and validity of R rays against T triangles.

    p, d: (R, 3). Returns (t, valid): (R, T) float32 / bool. The math of
    triangle_intersect (prog.cl:94-112): t from the plane equation,
    validity from t > 0 (prog.cl:100, 117) and the three half-plane
    tests dot(p, m_k) >= dot(v_k, m_k) at p = P + t V. A parallel ray's
    t is inf or nan, and every comparison with it is false: a miss."""
    pn = _dot_rows(p, tris.n)
    vn = _dot_rows(d, tris.n)
    t = (tris.c0[None, :] - pn) / vn

    def edge(m, dk):
        return _dot_rows(p, m) + t * _dot_rows(d, m) - dk[None, :]

    e1 = edge(tris.m1, tris.d1)
    e2 = edge(tris.m2, tris.d2)
    e3 = edge(tris.m3, tris.d3)
    valid = (t > 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & (e3 >= 0.0)
    return t, valid


def ray_tri_mt(p: V3, d: V3, r1: V3, r2: V3, r3: V3, *, eps: float = 0.0):
    """Moller-Trumbore ray/triangle test over matched batches (lane i:
    ray i against triangle i). p, d, r1, r2, r3: V3 of (N,) tensors.
    Returns (t, u, v, valid); (u, v) weigh r2 and r3 (r1 weighs
    1 - u - v). det == 0 gives an infinite inverse and a miss."""
    e1 = vsub(r2, r1)
    e2 = vsub(r3, r1)
    pvec = vcross(d, e2)
    det = vdot(e1, pvec)
    inv = 1.0 / det
    tvec = vsub(p, r1)
    u = vdot(tvec, pvec) * inv
    qvec = vcross(tvec, e1)
    v = vdot(d, qvec) * inv
    t = vdot(e2, qvec) * inv
    valid = ((u >= -eps) & (v >= -eps) & (u + v <= 1.0 + eps)
             & (t > 0.0))
    return t, u, v, valid


def intersect_aabb(p: torch.Tensor, d: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor):
    """Slab test (BBox_intersection, prog.cl:123-143): division by the
    direction with no zero guard (IEEE +-inf), XLA's minimum and maximum
    (NaN wins, -0.0 below +0.0). Returns (hit, tmin, tmax) with
    hit = tmax >= tmin; rays (..., 3) broadcast against boxes (..., 3)."""
    t1 = (lo - p) / d
    t2 = (hi - p) / d
    near, far = _xmin(t1, t2), _xmax(t1, t2)
    tmin = _xmax(_xmax(near[..., 0], near[..., 1]), near[..., 2])
    tmax = _xmin(_xmin(far[..., 0], far[..., 1]), far[..., 2])
    return tmax >= tmin, tmin, tmax
