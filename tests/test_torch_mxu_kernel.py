"""K15 (the dense intersect with its dots as one matmul) in the port
against the JAX package's `_mxu_kernel` run in interpret mode.

Tolerance: none for the kernel and the intersector. The (T, 24) pack
that the port's K15 reads holds the JAX package's `build_mxu_pack`
arrays, laid out as they are, array for array; `mxu_plain` equals
interpret-mode `_run_mxu` bit for bit on all six outputs (t, index, nx,
ny, nz, mati), on random rays and on rays aimed at vertices and edges,
over one and several of its tiles, with a triangle 0 whose normal has a
-0.0 component (it comes out +0.0, on hits and on the miss lanes' latch
of triangle 0), and K4's rounding does not (its t differs on some lane);
`make_mxu_intersect`'s Hits equal JAX's bit for bit. A 16x16 Cornell
render through K15 matches JAX's jitted render through interpret-mode
K15 to the goldens' rtol 1e-4 (atol 1e-6): jit fuses the hit point's
multiply-add, the port does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.core.geometry import TrianglesSoA as JTris
from opencl_path_tracer_tpu.core.types import Rays as JRays
from opencl_path_tracer_tpu.models import megakernel as jmk
from opencl_path_tracer_tpu.ops.pallas import intersect_kernel as jk
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.types import Rays
from opencl_path_tracer_tpu_torch.models import megakernel
from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

# Axis-aligned triangles: the first has n = (-0.0, 0.0, 1.0), the last is
# degenerate (n = 0).
FLAT = (np.float32([[0, 0, 2], [0, 0, 2], [0, 2, 0], [2, 0, 0]]),
        np.float32([[1, -1, 2], [-1, 1, 2], [1, 2, -1], [2, 1, -1]]),
        np.float32([[1, 1, 2], [1, 1, 2], [-1, 2, -1], [2, -1, 1]]))


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def scene(t, seed=0):
    """The four FLAT triangles (moved 3 along x) then t - 4 random ones
    (tests/test_pallas.py's), as (vertices, JAX triangles, port
    triangles)."""
    rs = np.random.default_rng(seed)
    centers = rs.uniform(-10, 10, size=(t - 4, 1, 3))
    v = (centers + rs.normal(size=(t - 4, 3, 3)) * 0.6).astype(np.float32)
    flat = np.stack(FLAT, 1) + np.float32([3, 0, 0])
    v = np.concatenate([flat, v]).astype(np.float32)
    args = (v[:, 0], v[:, 1], v[:, 2], np.arange(t, dtype=np.int32) % 7)
    return v, JTris.build(*args), TrianglesSoA.build(*args)


def rays(v, n=512, seed=1):
    """n random rays, then 4n rays aimed at the triangles' edges (the
    first n of them at vertices); (R, 3) origins and directions."""
    rs = np.random.default_rng(seed)
    p = rs.uniform(-12, 12, size=(n, 3))
    d = rs.normal(size=(n, 3))
    m = 4 * n
    idx, e = rs.integers(0, v.shape[0], m), rs.integers(0, 3, m)
    s = rs.uniform(0, 1, (m, 1))
    s[:n] = 0.0
    a, b = v[idx, e], v[idx, (e + 1) % 3]
    o = rs.uniform(-12, 12, size=(m, 3))
    p = np.concatenate([p, o]).astype(np.float32)
    d = np.concatenate([d, a + s * (b - a) - o]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p, d


def both_rays(p, d):
    return (JRays(p=tuple(jnp.asarray(p[:, c]) for c in range(3)),
                  d=tuple(jnp.asarray(d[:, c]) for c in range(3))),
            Rays(p=tuple(torch.from_numpy(p[:, c].copy()) for c in range(3)),
                 d=tuple(torch.from_numpy(d[:, c].copy()) for c in range(3))))


def jax_layout(pack, tt):
    """The JAX package's (trig, tric) from the port's (Tpad, 24) pack:
    trig holds, tile by tile of tt triangles, the eight (tt, 8) row
    blocks [pn; vn; pm1; vm1; pm2; vm2; pm3; vm3] that map the ray rows
    [p(3) d(3) 0 0] to the dots (a P block has its vector in columns 0-2,
    a V block in columns 3-5); tric holds [c0 d1 d2 d3 nx ny nz mati]."""
    tpad = pack.shape[0]
    z = pack.new_zeros((tpad, 3))
    pad2 = pack.new_zeros((tpad, 2))
    blocks = []
    for base in (0, 4, 8, 12):
        v = pack[:, base:base + 3]
        blocks += [torch.cat([v, z, pad2], 1), torch.cat([z, v, pad2], 1)]
    trig = torch.stack(blocks).reshape(8, tpad // tt, tt, 8)
    trig = trig.permute(1, 0, 2, 3).reshape(tpad * 8, 8)
    return trig, pack[:, [3, 7, 11, 15, 0, 1, 2, 16]]


@pytest.mark.parametrize("t,tt", [(300, 128), (300, 64), (60, 128)])
def test_build_mxu_pack_equals_jax(t, tt):
    _, jt, pt = scene(t)
    jtrig, jtric, jtt = jk.build_mxu_pack(jt, tt)
    assert jtt == min(tt, jtric.shape[0])
    trig, tric = jax_layout(k.build_tri_pack(pt, tt), jtt)
    np.testing.assert_array_equal(_bits(trig.numpy()), _bits(jtrig))
    np.testing.assert_array_equal(_bits(tric.numpy()), _bits(jtric))


@pytest.mark.parametrize("t,tt", [(300, 128), (300, 64), (60, 128)])
def test_mxu_plain_bit_equal_to_interpret_kernel(t, tt):
    v, jt, pt = scene(t)
    p, d = rays(v)
    r = p.shape[0]
    j8 = jk.pack_rays(tuple(jnp.asarray(p[:, c]) for c in range(3)),
                      tuple(jnp.asarray(d[:, c]) for c in range(3)),
                      -(-r // 1024) * 1024)
    jtrig, jtric, jtt = jk.build_mxu_pack(jt, tt)
    want = [np.asarray(o)[:r] for o in jk._run_mxu(j8, jtrig, jtric, 1024,
                                                   jtt, True)]
    rays8 = torch.from_numpy(np.asarray(j8)[:, :r].copy())
    pack = k.build_tri_pack(pt)
    got = k.mxu(rays8, pack)
    for what, a, b in zip(("t", "index", "nx", "ny", "nz", "mati"), got,
                          want):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b),
                                      err_msg=what)
    hit = want[0] < k.BIG
    assert 0 < hit.sum() < r
    assert (jtric.shape[0] // jtt > 1) == (t == 300)     # several tiles
    # Triangle 0's -0.0 normal comes out +0.0: on the miss lanes' latch
    # and on its hits.
    assert torch.signbit(pack[0, 0]) and pack[0, 0] == 0.0
    assert not (torch.signbit(got[2]) & (got[2] == 0.0)).any()
    assert (got[1].numpy()[~hit] == 0).all()
    assert (got[1].numpy()[hit] == 0).any()
    # K4 (`_dot3`, fma(v2, a2, fma(v0, a0, v1 a1))) rounds otherwise.
    assert (_bits(k.dense(rays8, pack)[0].numpy()) != _bits(want[0])).any()


def test_make_mxu_intersect_hits_equal_jax():
    v, jt, pt = scene(300, seed=3)
    jr, pr = both_rays(*rays(v, 256, seed=4))
    jh = jk.make_mxu_intersect(jt, interpret=True)(jr)
    ph = k.make_mxu_intersect(pt)(pr)
    np.testing.assert_array_equal(_bits(ph.t.numpy()), _bits(jh.t))
    np.testing.assert_array_equal(ph.mati.numpy(), np.asarray(jh.mati))
    for c in range(3):
        np.testing.assert_array_equal(_bits(ph.n[c].numpy()), _bits(jh.n[c]))
        np.testing.assert_array_equal(_bits(ph.p[c].numpy()), _bits(jh.p[c]))
    miss = ph.t.numpy() == -1.0
    assert miss.any() and (ph.mati.numpy()[miss] == 0).all()
    # Miss lanes carry triangle 0's normal, unmasked: (+0.0, 0.0, 1.0).
    n0 = pt.n[0] + 0.0
    for c in range(3):
        assert (_bits(ph.n[c].numpy()[miss]) == _bits(n0[c].numpy())).all()


def test_mxu_render_matches_jax():
    js, ps = jlib.cornell_box(with_spheres=True), library.cornell_box(
        with_spheres=True)
    jst = jmk.render(jlib.cornell_camera(16, 16), js.mats,
                     intersect_fn=jk.make_mxu_intersect(js.tris,
                                                        interpret=True),
                     num_pixels=256, iterations=3, spp=2, mode="parity")
    pst = megakernel.render(library.cornell_camera(16, 16), ps.mats,
                            intersect_fn=k.make_mxu_intersect(ps.tris),
                            num_pixels=256, iterations=3, spp=2,
                            mode="parity", device="cpu")
    img = megakernel.colors_array(pst).numpy()
    assert np.isfinite(img).all() and img.max() > 0.0
    np.testing.assert_allclose(img, np.asarray(jmk.colors_array(jst)),
                               rtol=1e-4, atol=1e-6)


def test_mxu_wrapper_checks_and_cpu_counts_no_launch():
    _, _, pt = scene(60)
    pack = k.build_tri_pack(pt)
    before = dict(_build.launches)
    out = k.mxu(torch.zeros((8, 10)), pack)
    assert _build.launches == before
    assert (out[0] == k.BIG).all() and (out[1] == 0).all()
    with pytest.raises(ValueError):
        k.mxu(torch.zeros((6, 10)), pack)
    with pytest.raises(TypeError):
        k.mxu(torch.zeros((8, 10), dtype=torch.float64), pack)
    with pytest.raises(ValueError):
        k.mxu(torch.zeros((8, 10)), pack[:0])
    with pytest.raises(ValueError):
        k.mxu(torch.zeros((8, 10)), pack[:, :16].contiguous())
