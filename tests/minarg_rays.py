"""An adversarial batch for K1 (csrc/minarg.cu), whose kernel settles
most (ray, triangle) pairs by sign or by distance before the divide:
rays with a zero direction (both signs of zero), NaN and infinite rays,
origins on a triangle's plane (at a vertex, an edge midpoint, the
centroid), rays parallel to a triangle's plane (along an edge), rays with
a subnormal direction component, and rays aimed at vertices; and a pack
whose rows repeat, so that some rays meet exact t ties. For K13a
(csrc/plucker_cand.cu), a mesh of parallel planes and lanes that accept
t above BIG on every one of its rows. Shared by
tests/test_torch_minarg_cull.py (the plain twin of the culled loop),
tests/test_torch_plucker_mma.py, tests/test_torch_cuda.py (the kernels
on the card) and chip_smoke.py."""

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA

KINDS = 8


def adversarial_rays(tris, n, seed):
    """(8, n) float32 rays against the triangles `tris` (TrianglesSoA),
    the kinds of the module docstring in turn (lane i is kind i % 8)."""
    rs = np.random.default_rng(seed)
    r1, r2, r3 = (np.asarray(getattr(tris, f).cpu().numpy(), np.float64)
                  for f in ("r1", "r2", "r3"))
    k = rs.integers(0, r1.shape[0], n)
    a, b, c = r1[k], r2[k], r3[k]
    cen = (a + b + c) / 3.0
    u = rs.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    nrm = np.cross(b - a, c - a)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-30)
    edge = b - a
    edge /= np.maximum(np.linalg.norm(edge, axis=1, keepdims=True), 1e-30)
    kind = np.arange(n) % KINDS
    half = rs.random(n) < 0.5
    p = cen + 30.0 * u
    d = cen - p
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # 0: zero direction, +0.0 or -0.0 components.
    z = kind == 0
    d[z] = np.where(half[z, None], 0.0, -0.0)
    # 1: NaN in the direction or the origin; infinity in the direction.
    m = kind == 1
    d[m & half, 0] = np.nan
    p[m & ~half, 1] = np.nan
    m = kind == 7
    d[m & half] = np.array([np.inf, 0.0, 0.0])
    d[m & ~half, 2] = -np.inf
    # 2, 3: the origin on the triangle's plane (a vertex, an edge midpoint
    # or the centroid), a random direction.
    m = kind == 2
    p[m] = np.where(half[m, None], a[m], cen[m])
    d[m] = u[m]
    m = kind == 3
    p[m] = 0.5 * (a[m] + b[m])
    d[m] = np.where(half[m, None], u[m], -nrm[m])
    # 4: parallel to the plane, along an edge, on it or just off it.
    m = kind == 4
    p[m] = np.where(half[m, None], cen[m], cen[m] + 1e-3 * nrm[m])
    d[m] = edge[m]
    # 5: a subnormal direction component.
    m = kind == 5
    d[m, 1] = np.where(half[m], 1e-40, -1e-41)
    # 6: aimed at a vertex from 20 units away.
    m = kind == 6
    p[m] = a[m] + 20.0 * u[m]
    d[m] = (a[m] - p[m]) / 20.0
    r8 = np.zeros((8, n), np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        r8[0:3], r8[3:6] = p.T, d.T
    return r8


def tie_pack(pack):
    """The (T, 24) pack followed by itself: every hit of the first half
    ties exactly with its twin, which must lose (the lower index wins)."""
    return torch.cat([pack, pack]).contiguous()


def planes(n):
    """n triangles on the planes x + y + z = c, c = 1, 1.01, ...: unit
    normals of three positive components, every plane in front of the
    origin."""
    c = 1.0 + 0.01 * np.arange(n)
    z = np.zeros(n)
    return TrianglesSoA.build(np.stack([c, z, z], 1), np.stack([z, c, z], 1),
                              np.stack([z, z, c], 1), np.zeros(n, np.int32))


def t_above_big_rays(n):
    """(8, n) lanes that accept t above BIG on every row of planes():
    zero directions (vn = +0, t = c0 / +0 = inf) and subnormal ones
    (t = c0 / vn overflows), from the origin and from points behind it."""
    rs = np.random.default_rng(12)
    r8 = np.zeros((8, n), np.float32)
    r8[0:3] = -rs.uniform(0, 0.3, (3, n)) * (np.arange(n) % 3 > 0)
    r8[3:6, 1::2] = 1e-39
    return torch.as_tensor(r8)

