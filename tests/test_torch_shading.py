"""Smooth shading in the port (`ops/shading.py`) against the JAX package's
`ops/shading.py` on the CPU, on the same numpy-seeded triangles, corner
normals, texture coordinates and hits.

The packed attribute rows, the barycentrics, the texture coordinates and
the vertex normals of a mesh are bit-equal: the same float64 host
arithmetic, then the same float32 operations op by op (JAX eager). The
interpolated normals are bit-equal off the smooth lanes and within
atol 1e-6 on them: JAX normalises with XLA's approximate `rsqrt`, the
port with a correctly rounded 1 / sqrt (an ulp or two of a unit
vector)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.core.types import Hits as JHits
from opencl_path_tracer_tpu.ops import shading as jshading
from opencl_path_tracer_tpu_torch.core.types import Hits
from opencl_path_tracer_tpu_torch.ops import shading

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

T, R = 40, 2000


def _mesh(seed=0, with_uv=True):
    """T random triangles (two degenerate), corner normals (zero on every
    fourth triangle: no vertex normals there) and texture coordinates."""
    rs = np.random.default_rng(seed)
    r1 = rs.normal(size=(T, 3)).astype(np.float32) * 100.0
    r2 = r1 + rs.normal(size=(T, 3)).astype(np.float32) * 30.0
    r3 = r1 + rs.normal(size=(T, 3)).astype(np.float32) * 30.0
    r3[5] = r2[5]                      # degenerate: two equal corners
    r2[9], r3[9] = r1[9], r1[9]        # degenerate: a point
    n = [rs.normal(size=(T, 3)).astype(np.float32) for _ in range(3)]
    for k in range(3):
        n[k] /= np.linalg.norm(n[k], axis=1, keepdims=True)
        n[k][::4] = 0.0
    n[0][1, 0] = -0.0
    uv = ([rs.uniform(size=(T, 2)).astype(np.float32) for _ in range(3)]
          if with_uv else [None] * 3)
    return r1, r2, r3, n, uv


def _attribs(seed=0, with_uv=True):
    r1, r2, r3, n, uv = _mesh(seed, with_uv)
    return (jshading.build_vertex_attribs(r1, r2, r3, *n, *uv),
            shading.build_vertex_attribs(r1, r2, r3, *n, *uv),
            (r1, r2, r3))


def _hits(verts, seed=1):
    """R hits on random triangles at random barycentric points (a tenth
    of them misses, id -1), with random face normals."""
    r1, r2, r3 = verts
    rs = np.random.default_rng(seed)
    ids = rs.integers(0, T, R).astype(np.int32)
    ids[::10] = -1
    u = rs.uniform(size=R).astype(np.float32)
    v = (rs.uniform(size=R) * (1.0 - u)).astype(np.float32)
    g = np.maximum(ids, 0)
    p = ((1.0 - u - v)[:, None] * r1[g] + u[:, None] * r2[g]
         + v[:, None] * r3[g]).astype(np.float32)
    t = np.where(ids >= 0, rs.uniform(1, 500, R), -1.0).astype(np.float32)
    fn = rs.normal(size=(R, 3)).astype(np.float32)
    m = rs.integers(0, 9, R).astype(np.int32)
    jh = JHits(t=jnp.asarray(t), p=tuple(jnp.asarray(p[:, k])
                                         for k in range(3)),
               n=tuple(jnp.asarray(fn[:, k]) for k in range(3)),
               mati=jnp.asarray(m))
    ph = Hits(t=torch.from_numpy(t),
              p=tuple(torch.from_numpy(p[:, k].copy()) for k in range(3)),
              n=tuple(torch.from_numpy(fn[:, k].copy()) for k in range(3)),
              mati=torch.from_numpy(m))
    return jh, ph, ids


def _bits(a, b):
    return np.array_equal(np.asarray(a, np.float32).view(np.uint32),
                          np.asarray(b, np.float32).view(np.uint32))


@pytest.mark.parametrize("with_uv", [True, False])
def test_build_vertex_attribs_bit_equal(with_uv):
    ja, pa, _ = _attribs(with_uv=with_uv)
    assert pa.count == ja.count == T
    assert pa.packed.shape == (T, shading.PACK_COLS)
    assert _bits(pa.packed.numpy(), ja.packed)
    for f in ("n1", "n2", "n3", "gu", "gv", "uv1", "uv2", "uv3"):
        for a, b in zip(getattr(pa, f), getattr(ja, f)):
            assert _bits(a.numpy(), b), f
    assert _bits(pa.u0.numpy(), ja.u0) and _bits(pa.v0.numpy(), ja.v0)


def test_compute_vertex_normals_equal():
    rs = np.random.default_rng(3)
    verts = rs.normal(size=(30, 3)).astype(np.float32)
    faces = rs.integers(0, 25, size=(50, 3))   # vertices 25-29 unused
    got = shading.compute_vertex_normals(verts, faces)
    assert _bits(got, jshading.compute_vertex_normals(verts, faces))
    assert (got[25:] == 0.0).all()


def test_barycentrics_and_uvs_bit_equal():
    ja, pa, verts = _attribs()
    jh, ph, ids = _hits(verts)
    g = np.maximum(ids, 0)
    ju, jv = jshading.barycentrics(jh.p, jnp.asarray(g), ja)
    pu, pv = shading.barycentrics(ph.p, torch.from_numpy(g), pa)
    assert _bits(pu.numpy(), ju) and _bits(pv.numpy(), jv)
    js, jt = jshading.interpolate_uvs(jh, jnp.asarray(ids), ja)
    ps, pt = shading.interpolate_uvs(ph, torch.from_numpy(ids), pa)
    assert _bits(ps.numpy(), js) and _bits(pt.numpy(), jt)
    assert (ps.numpy()[ids < 0] == 0.0).all()


def test_smooth_hit_normals_match_jax():
    ja, pa, verts = _attribs()
    jh, ph, ids = _hits(verts)
    ref = jshading.smooth_hit_normals(jh, jnp.asarray(ids), ja)
    got = shading.smooth_hit_normals(ph, torch.from_numpy(ids), pa)
    assert _bits(got.t.numpy(), ref.t)
    assert np.array_equal(got.mati.numpy(), np.asarray(ref.mati))
    smooth = np.any([np.asarray(ref.n[k]) != np.asarray(jh.n[k])
                     for k in range(3)], axis=0)
    assert 1000 < smooth.sum() < R
    assert not smooth[ids < 0].any()
    bit = 0
    for k in range(3):
        a, b = got.n[k].numpy(), np.asarray(ref.n[k])
        assert _bits(a[~smooth], b[~smooth])
        np.testing.assert_allclose(a[smooth], b[smooth], rtol=0, atol=1e-6)
        bit += int((a[smooth] == b[smooth]).sum())
    assert bit > 0.5 * 3 * smooth.sum()   # most values bit-equal
    norm = sum(got.n[k].numpy()[smooth] ** 2 for k in range(3))
    np.testing.assert_allclose(norm, 1.0, atol=1e-6)
