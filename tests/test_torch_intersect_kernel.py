"""K1 (minarg) in the port against the JAX package's Pallas kernel run
in interpret mode: the nearest t and the winning index must be bit-equal,
on random triangle clouds with duplicated (tied) and degenerate
triangles, and on the Cornell box."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.core.geometry import TrianglesSoA as JTris
from opencl_path_tracer_tpu.ops.pallas import intersect_kernel as jk
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.scene import library as plib

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)


def _cloud(t, seed):
    rs = np.random.default_rng(seed)
    centers = rs.uniform(-10, 10, size=(t, 1, 3))
    v = (centers + rs.normal(size=(t, 3, 3)) * 0.6).astype(np.float32)
    v[t // 2:t // 2 + 5] = v[:5]           # exact ties: lower index wins
    v[-3:, 2] = v[-3:, 1]                  # zero-area triangles
    mati = np.arange(t, dtype=np.int32) % 7
    args = (v[:, 0], v[:, 1], v[:, 2], mati)
    return JTris.build(*args), TrianglesSoA.build(*args)


def _rays(n, seed, spread=12.0):
    rs = np.random.default_rng(seed)
    p = rs.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p, d


def _jax_minarg(jtris, p, d):
    pack = jk.build_tri_pack(jtris, 1024)
    r = p.shape[0]
    rpad = -(-r // 256) * 256
    rays8 = jk.pack_rays(tuple(jnp.asarray(p[:, k]) for k in range(3)),
                         tuple(jnp.asarray(d[:, k]) for k in range(3)), rpad)
    t, g = jk._run_minarg(rays8, pack, 256, min(1024, pack.shape[0]), True,
                          512)
    return np.asarray(t)[0, :r], np.asarray(g)[0, :r]


def _port_minarg(ptris, p, d):
    rays8 = k1.pack_rays(tuple(torch.from_numpy(p[:, k].copy())
                               for k in range(3)),
                         tuple(torch.from_numpy(d[:, k].copy())
                               for k in range(3)))
    t, g = k1.minarg(rays8, k1.build_tri_pack(ptris))
    return t.numpy(), g.numpy()


@pytest.mark.parametrize("t,n,seed", [(60, 300, 0), (700, 400, 1)])
def test_minarg_bit_equal_random_cloud(t, n, seed):
    jt, pt = _cloud(t, seed)
    p, d = _rays(n, seed + 10)
    # Rays through the tied triangles' centroids hit a tie for sure.
    cen = np.asarray(jt.r1[:5] + jt.r2[:5] + jt.r3[:5]) / 3.0
    p[:5] = cen - 30.0 * d[:5]
    jt_, jg = _jax_minarg(jt, p, d)
    pt_, pg = _port_minarg(pt, p, d)
    np.testing.assert_array_equal(pt_.view(np.int32), jt_.view(np.int32))
    np.testing.assert_array_equal(pg, jg)
    hit = jt_ < k1.BIG
    assert 0 < hit.sum() < n                      # hits and misses both
    assert (pg[~hit] == 0).all()                  # miss: BIG and index 0
    # The copies at t//2.. tie with triangles 0..4: the lower index wins.
    assert (pg[:5] == np.arange(5)).any()
    assert not ((pg[:5] >= t // 2) & (pg[:5] < t // 2 + 5)).any()


def test_minarg_bit_equal_cornell():
    js = jlib.cornell_box(with_spheres=True)
    ps = plib.cornell_box(with_spheres=True)
    rs = np.random.default_rng(3)
    p = np.stack([rs.uniform(-100, 1100, 500), rs.uniform(0, 1000, 500),
                  rs.uniform(-1000, 1000, 500)], 1).astype(np.float32)
    d = rs.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jt_, jg = _jax_minarg(js.tris, p, d)
    pt_, pg = _port_minarg(ps.tris, p, d)
    np.testing.assert_array_equal(pt_.view(np.int32), jt_.view(np.int32))
    np.testing.assert_array_equal(pg, jg)


def test_minarg_wrapper_checks_and_cpu_counts_no_launch():
    _, pt = _cloud(20, 0)
    pack = k1.build_tri_pack(pt)
    rays8 = torch.zeros((8, 10))
    before = dict(_build.launches)
    k1.minarg(rays8, pack)
    assert _build.launches == before
    with pytest.raises(ValueError):
        k1.minarg(torch.zeros((6, 10)), pack)
    with pytest.raises(TypeError):
        k1.minarg(rays8.double(), pack)
    with pytest.raises(ValueError):
        k1.minarg(rays8, pack[:, :16])
    with pytest.raises(ValueError):
        k1.minarg(rays8, pack[:0])                    # no triangles
    with pytest.raises(ValueError):
        k1.minarg(torch.zeros((10, 8)).t(), pack)   # not contiguous
