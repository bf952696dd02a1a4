"""Hit-point attribute interpolation: barycentrics and smooth shading.

Port of `opencl_path_tracer_tpu/ops/shading.py`: `VertexAttribs`,
`build_vertex_attribs`, `_bary_from_rows`, `barycentrics`,
`smooth_hit_normals`, `interpolate_uvs` and `compute_vertex_normals`.

The reference shades with the face normal only (its Hit struct,
prog.cl:11-16) and never reads the vertex normals tinyobj parses
(main.cpp:595-611). Here OBJ `vn` data, computed or analytic vertex
normals become shading normals by barycentric interpolation. The
barycentric weight of a corner is an affine function of the hit point,
so each triangle carries gradient rows (gu, gv) and offsets (u0, v0),
built once on the host:

    u(p) = dot(p, gu) + u0      (weight of r2)
    v(p) = dot(p, gv) + v0      (weight of r3)
    w(p) = 1 - u - v            (weight of r1)

The functions here run op by op, as the JAX package's do outside a
jit: no fused multiply-adds. The normalisation divides by a correctly
rounded square root, where XLA's CPU `rsqrt` is an approximation, so
a normal can differ from JAX's by an ulp or two of its unit length.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.core.types import V3, Hits, vwhere

PACK_COLS = 17   # [gu(3) gv(3) u0 v0 n1(3) n2(3) n3(3)]


@dataclasses.dataclass(frozen=True)
class VertexAttribs:
    """Per-triangle corner attributes and barycentric gradients.

    n1, n2, n3: V3 of (T,) unit shading normals at the corners r1, r2,
        r3. An all-zero corner triple means "no vertex normals": the
        interpolated vector is 0 and smooth_hit_normals keeps the face
        normal for that triangle.
    gu, gv: V3 of (T,) barycentric gradient rows; u0, v0: (T,) offsets.
    uv1, uv2, uv3: ((T,), (T,)) per-corner texture coordinates, zeros
        when the mesh has no vt.
    packed: (T, 17) float32 rows [gu gv u0 v0 n1 n2 n3], the table the
        row gathers and the smooth refine kernel (K8) read.
    """

    n1: V3
    n2: V3
    n3: V3
    gu: V3
    gv: V3
    u0: torch.Tensor
    v0: torch.Tensor
    uv1: tuple
    uv2: tuple
    uv3: tuple
    packed: torch.Tensor

    @property
    def count(self) -> int:
        return int(self.u0.shape[0])

    def to(self, device) -> "VertexAttribs":
        def mv(a):
            return (tuple(mv(c) for c in a) if isinstance(a, tuple)
                    else a.to(device))

        return VertexAttribs(**{f.name: mv(getattr(self, f.name))
                                for f in dataclasses.fields(self)})


def build_vertex_attribs(r1, r2, r3, n1, n2, n3, uv1=None, uv2=None,
                         uv3=None, device="cpu") -> VertexAttribs:
    """Host-side build. r*, n*: (T, 3) arrays; uv*: optional (T, 2)
    per-corner texture coordinates (zeros when absent).

    The gradients are computed in float64 (the denominator d00 d11 -
    d01^2 loses half its bits in float32 for thin triangles), then
    stored as float32. Degenerate triangles get zero gradients, so a hit
    on one takes its r1 corner's normal (a zero-area triangle can still
    be hit: the fused cross product may leave it a unit face normal,
    ROADMAP.md queue 3)."""
    r1 = np.asarray(r1, np.float64).reshape(-1, 3)
    r2 = np.asarray(r2, np.float64).reshape(-1, 3)
    r3 = np.asarray(r3, np.float64).reshape(-1, 3)
    e1 = r2 - r1
    e2 = r3 - r1
    d00 = np.sum(e1 * e1, -1)
    d01 = np.sum(e1 * e2, -1)
    d11 = np.sum(e2 * e2, -1)
    denom = d00 * d11 - d01 * d01
    safe = np.where(denom > 0.0, denom, 1.0)
    gu = (d11[:, None] * e1 - d01[:, None] * e2) / safe[:, None]
    gv = (d00[:, None] * e2 - d01[:, None] * e1) / safe[:, None]
    dead = denom <= 0.0
    gu[dead] = 0.0
    gv[dead] = 0.0
    u0 = -np.sum(r1 * gu, -1)
    v0 = -np.sum(r1 * gv, -1)
    t = r1.shape[0]

    def f32(a, w):
        return np.asarray(a, np.float32).reshape(-1, w)

    def uv(a):
        return np.zeros((t, 2), np.float32) if a is None else f32(a, 2)

    packed = np.concatenate([
        f32(gu, 3), f32(gv, 3), f32(u0, 1), f32(v0, 1),
        f32(n1, 3), f32(n2, 3), f32(n3, 3)], axis=1)
    pk = torch.as_tensor(np.ascontiguousarray(packed), device=device)
    uvs = [torch.as_tensor(np.ascontiguousarray(uv(a).T), device=device)
           for a in (uv1, uv2, uv3)]

    def v3(base):
        return (pk[:, base].contiguous(), pk[:, base + 1].contiguous(),
                pk[:, base + 2].contiguous())

    return VertexAttribs(
        n1=v3(8), n2=v3(11), n3=v3(14), gu=v3(0), gv=v3(3),
        u0=pk[:, 6].contiguous(), v0=pk[:, 7].contiguous(),
        uv1=(uvs[0][0], uvs[0][1]), uv2=(uvs[1][0], uvs[1][1]),
        uv3=(uvs[2][0], uvs[2][1]), packed=pk,
    )


def _bary_from_rows(p: V3, rows: torch.Tensor):
    """(u, v) from gathered (R, 17) pack rows."""
    u = p[0] * rows[:, 0] + p[1] * rows[:, 1] + p[2] * rows[:, 2] \
        + rows[:, 6]
    v = p[0] * rows[:, 3] + p[1] * rows[:, 4] + p[2] * rows[:, 5] \
        + rows[:, 7]
    return u, v


def barycentrics(p: V3, ids: torch.Tensor, attribs: VertexAttribs):
    """(u, v) barycentric coordinates of hit points p on triangles ids
    (already clamped to >= 0). u weights r2, v weights r3; the r1
    weight is 1 - u - v."""
    return _bary_from_rows(p, attribs.packed[ids.long()])


def smooth_hit_normals(hits: Hits, ids: torch.Tensor,
                       attribs: VertexAttribs) -> Hits:
    """Replace face normals with interpolated vertex normals.

    ids: (R,) triangle index per hit, -1 on a miss. Misses and
    triangles whose corner normals are all zero keep the face normal.
    The interpolated vector is renormalised; its side is not forced
    here (the models flip the normal toward the incoming ray)."""
    ok = hits.valid & (ids >= 0)
    rows = attribs.packed[torch.clamp_min(ids, 0).long()]
    u, v = _bary_from_rows(hits.p, rows)
    w = 1.0 - u - v
    ns = tuple(w * rows[:, 8 + k] + u * rows[:, 11 + k]
               + v * rows[:, 14 + k] for k in range(3))
    nn2 = ns[0] * ns[0] + ns[1] * ns[1] + ns[2] * ns[2]
    big = nn2 > 1e-12
    use = ok & big
    inv = torch.reciprocal(fp.sqrt(torch.where(big, nn2,
                                               torch.ones_like(nn2))))
    n = vwhere(use, tuple(ns[k] * inv for k in range(3)), hits.n)
    return Hits(t=hits.t, p=hits.p, n=n, mati=hits.mati)


def interpolate_uvs(hits: Hits, ids: torch.Tensor, attribs: VertexAttribs):
    """Texture coordinates at the hit points: (s, t), 0 on a miss."""
    ok = hits.valid & (ids >= 0)
    idx = torch.clamp_min(ids, 0).long()
    u, v = _bary_from_rows(hits.p, attribs.packed[idx])
    w = 1.0 - u - v

    def blend(comp):
        return (w * attribs.uv1[comp][idx] + u * attribs.uv2[comp][idx]
                + v * attribs.uv3[comp][idx])

    z = torch.zeros_like(u)
    return torch.where(ok, blend(0), z), torch.where(ok, blend(1), z)


def compute_vertex_normals(vertices: np.ndarray,
                           faces: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals of an indexed mesh (host
    side). vertices: (V, 3); faces: (F, 3) indices. Each face adds its
    unnormalised cross product to its three vertices; vertices with no
    area get 0."""
    vertices = np.asarray(vertices, np.float64).reshape(-1, 3)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    v0 = vertices[faces[:, 0]]
    fn = np.cross(vertices[faces[:, 1]] - v0, vertices[faces[:, 2]] - v0)
    acc = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(acc, faces[:, k], fn)
    norm = np.linalg.norm(acc, axis=1, keepdims=True)
    out = np.where(norm > 0.0, acc / np.where(norm > 0.0, norm, 1.0), 0.0)
    return out.astype(np.float32)
