"""Lanes whose Plucker edge values lie near zero, where K18's certified
margin sends an edge test to the float32 chain: rays aimed at triangle
vertices, rays along triangle edges, and rays that graze a triangle's
plane. Shared by tests/test_torch_march_margin.py (the margin on the CPU)
and tests/test_torch_cuda.py (the kernel on the card)."""

import numpy as np


def grazing_rays(tris, n, seed):
    """(8, n) float32 rays against the triangles `tris` (TrianglesSoA):
    in turn aimed at a vertex from 40 units away, along an edge from
    half an edge before its first vertex, and nearly in a triangle's
    plane towards its centroid (1e-3 above it, tilted 1e-5 down)."""
    rs = np.random.default_rng(seed)
    r1, r2, r3 = (np.asarray(getattr(tris, f).cpu().numpy(), np.float64)
                  for f in ("r1", "r2", "r3"))
    t = rs.integers(0, r1.shape[0], n)
    a, b, c = r1[t], r2[t], r3[t]
    u = rs.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    nrm = np.cross(b - a, c - a)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-30)
    w = b - a
    w /= np.maximum(np.linalg.norm(w, axis=1, keepdims=True), 1e-30)
    cen = (a + b + c) / 3.0
    kind = np.arange(n) % 3
    p = np.where((kind == 0)[:, None], a + 40.0 * u,
                 np.where((kind == 1)[:, None], a - 0.5 * (b - a),
                          cen - 40.0 * w + 1e-3 * nrm))
    d = np.where((kind == 0)[:, None], a - p,
                 np.where((kind == 1)[:, None], b - a, w - 1e-5 * nrm))
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)
    r8 = np.zeros((8, n), np.float32)
    r8[0:3], r8[3:6] = p.T, d.T
    return r8


def aimed_rays(n, seed, tris):
    """(8, n) float32 rays from inside the stress box, aimed at a jittered
    triangle corner (every seventh in a random direction)."""
    rs = np.random.default_rng(seed)
    p = np.stack([rs.uniform(-90, 1090, n), rs.uniform(10, 990, n),
                  rs.uniform(-990, 990, n)], 1)
    corners = tris.r1.cpu().numpy()
    d = corners[rs.integers(0, corners.shape[0], n)] + rs.normal(
        size=(n, 3)) - p
    d[::7] = rs.normal(size=d[::7].shape)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r8 = np.zeros((8, n), np.float32)
    r8[0:3], r8[3:6] = p.T, d.T
    return r8
