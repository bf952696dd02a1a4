"""The JAX package's test surface of `ops/intersect.py` and `ops/rng.py`
that no render path calls, in the port, against the JAX functions on
the CPU: `ray_tri_t`, `ray_tri_mt` and `intersect_aabb` on the cases of
tests/test_intersect.py, tests/test_shading.py and tests/test_spheres.py
plus seeded random batches with parallel rays, zero determinants and
zero direction components, and `lehmer_reference_sequence`.

Tolerance: none. `valid` and `hit` are equal, and t, u, v, tmin and
tmax bit-equal (NaN where JAX has NaN): `ray_tri_t`'s dots round as
XLA's CPU dot does (fma(a2, b2, fma(a1, b1, a0 * b0)), probed on
(R, 3) x (3, T) from 1 x 1 to 300 x 257); the rest is eager JAX, one
rounding an operation, as the port's plain PyTorch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.core.geometry import TrianglesSoA as JTris
from opencl_path_tracer_tpu.core.types import v3_from_array
from opencl_path_tracer_tpu.ops import intersect as jisect
from opencl_path_tracer_tpu.ops import rng as jrng
from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.ops import intersect, rng

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)


def _bits(x) -> np.ndarray:
    """Float32 values as their bits, every NaN as one pattern."""
    x = np.asarray(x, np.float32)
    return np.where(np.isnan(x), np.uint32(0x7FC00000),
                    x.view(np.uint32))


def _same(ours: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(_bits(ours.numpy()), _bits(ref))


def _v3(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                 for k in range(3))


def _random_scene(seed, T, R, parallel=0):
    rs = np.random.default_rng(seed)
    v = rs.normal(size=(T, 3, 3)).astype(np.float32) * 2.0
    p = rs.normal(size=(R, 3)).astype(np.float32) * 3.0
    d = rs.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if parallel:
        # The first triangle lies in z = 0 (n = (0, 0, 1) exactly), and
        # the first rays run parallel to it (vn = 0: t is +-inf, or nan
        # where the origin lies in the plane too).
        v[0] = [[0, 0, 0], [2, 0, 0], [0, 2, 0]]
        d[:parallel, 2] = 0.0
        p[:parallel // 2, 2] = 0.0
    return v, p, d


@pytest.mark.parametrize("seed,T,R,parallel", [
    (3, 64, 128, 0),     # tests/test_intersect.py:104's scene
    (7, 33, 200, 12),
    (11, 257, 65, 6),
    (5, 1, 1, 0),
])
def test_ray_tri_t_equals_jax(seed, T, R, parallel):
    v, p, d = _random_scene(seed, T, R, parallel)
    mati = np.arange(T, dtype=np.int32)
    t_ref, valid_ref = jisect.ray_tri_t(
        jnp.asarray(p), jnp.asarray(d),
        JTris.build(v[:, 0], v[:, 1], v[:, 2], mati))
    t, valid = intersect.ray_tri_t(
        torch.from_numpy(p), torch.from_numpy(d),
        TrianglesSoA.build(v[:, 0], v[:, 1], v[:, 2], mati))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_ref))
    _same(t, t_ref)
    assert t.shape == (R, T) and valid.dtype == torch.bool
    if parallel:
        # The in-plane rays miss the first triangle through inf or nan.
        assert not valid[:parallel, 0].any()
        assert not torch.isfinite(t[:parallel, 0]).any()
        assert torch.isnan(t[:parallel // 2, 0]).all()


def _mt_cases(name):
    rs = np.random.default_rng(1)
    if name == "shading":
        # tests/test_shading.py:71-83: rays aimed at interior points.
        n = 256
        r1 = rs.normal(size=(n, 3)).astype(np.float32)
        r2 = r1 + rs.normal(size=(n, 3)).astype(np.float32)
        r3 = r1 + rs.normal(size=(n, 3)).astype(np.float32)
        w = rs.dirichlet((2.0, 2.0, 2.0), n).astype(np.float32)
        target = w[:, 0:1] * r1 + w[:, 1:2] * r2 + w[:, 2:3] * r3
        p = target + np.float32([0, 0, 7]) + rs.normal(
            size=(n, 3)).astype(np.float32) * 0.1
        d = (target - p).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    else:
        # tests/test_spheres.py:132-155: random pairs; "degenerate" adds
        # zero-area triangles and rays parallel to their triangle (det 0).
        n = 512
        r1 = rs.normal(size=(n, 3)).astype(np.float32)
        r2 = r1 + rs.normal(size=(n, 3)).astype(np.float32)
        r3 = r1 + rs.normal(size=(n, 3)).astype(np.float32)
        p = rs.normal(size=(n, 3)).astype(np.float32) * 3
        d = rs.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        if name == "degenerate":
            r3[:32] = r2[:32]
            d[32:64] = (r2 - r1)[32:64]
            p[48:64] = r1[48:64]
    return p, d, r1, r2, r3


@pytest.mark.parametrize("name", ["shading", "spheres", "degenerate"])
@pytest.mark.parametrize("eps", [0.0, 1e-4])
def test_ray_tri_mt_equals_jax(name, eps):
    arrays = _mt_cases(name)
    ref = jisect.ray_tri_mt(*(v3_from_array(jnp.asarray(a))
                              for a in arrays), eps=eps)
    ours = intersect.ray_tri_mt(*(_v3(a) for a in arrays), eps=eps)
    np.testing.assert_array_equal(ours[3].numpy(), np.asarray(ref[3]))
    for a, b in zip(ours[:3], ref[:3]):
        _same(a, b)
    if name == "shading":
        assert ours[3].float().mean() > 0.95
    if name == "degenerate":
        assert not ours[3][:64].any()


def test_intersect_aabb_slab_cases():
    """tests/test_intersect.py:151-161: a hit at [4, 6], a sideways miss,
    an axis-parallel ray inside the slab (division by zero -> inf)."""
    lo, hi = np.float32([[-1, -1, -1]]), np.float32([[1, 1, 1]])
    d = np.float32([[0, 0, 1]])
    for p, want in (([[0, 0, -5]], True), ([[5, 0, -5]], False),
                    ([[0.5, 0.5, -5]], True)):
        args = [np.float32(p), d, lo, hi]
        hit, tmin, tmax = intersect.intersect_aabb(
            *map(torch.from_numpy, args))
        ref = jisect.intersect_aabb(*map(jnp.asarray, args))
        assert bool(hit[0]) is want and bool(ref[0][0]) is want
        _same(tmin, ref[1])
        _same(tmax, ref[2])
    hit, tmin, tmax = intersect.intersect_aabb(
        torch.tensor([[0.0, 0.0, -5.0]]), torch.from_numpy(d),
        torch.from_numpy(lo), torch.from_numpy(hi))
    assert float(tmin[0]) == 4.0 and float(tmax[0]) == 6.0


def test_intersect_aabb_random_broadcast():
    rs = np.random.default_rng(4)
    R, B = 96, 40
    p = rs.normal(size=(R, 1, 3)).astype(np.float32) * 4
    d = rs.normal(size=(R, 1, 3)).astype(np.float32)
    d[rs.random(size=d.shape) < 0.15] = 0.0          # +-inf slabs
    d[:8, 0, 0] = -0.0
    c = rs.normal(size=(1, B, 3)).astype(np.float32) * 3
    ext = np.abs(rs.normal(size=(1, B, 3))).astype(np.float32)
    lo, hi = c - ext, c + ext
    p[8:16, 0, :] = lo[0, :8, :]                      # 0 / 0 = nan
    args = (p, d, lo, hi)
    ours = intersect.intersect_aabb(*map(torch.from_numpy, args))
    ref = jisect.intersect_aabb(*map(jnp.asarray, args))
    assert ours[0].shape == (R, B)
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
    _same(ours[1], ref[1])
    _same(ours[2], ref[2])
    assert torch.isnan(ours[1]).any() and torch.isinf(ours[2]).any()
    assert ours[0].any() and not ours[0].all()


@pytest.mark.parametrize("state,n", [(1, 10), (2147483646, 7),
                                     (123456789, 1000), (5, 0)])
def test_lehmer_reference_sequence_equals_jax(state, n):
    ours = rng.lehmer_reference_sequence(state, n)
    assert ours == jrng.lehmer_reference_sequence(state, n)
    assert len(ours) == n and all(0 < x < rng.M31 for x in ours)
    # The device stream steps through the same states.
    st = torch.tensor([state], dtype=torch.int64)
    for want in ours[:20]:
        st, _ = rng.lehmer_step(st)
        assert int(st[0]) == want
