"""K4 (the dense exact intersector with attributes) in the port against
the JAX package's Pallas kernel run in interpret mode: t, the winner's
index and its material bit-equal on every lane, normals bit-equal on hit
lanes and on the miss lanes' latch of row 0, on the random scenes of
tests/test_plucker.py and on the Cornell box; and accel='pallas' through
16x16 megakernel renders against the goldens."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.core.geometry import TrianglesSoA as JTris
from opencl_path_tracer_tpu.ops import raygen as jraygen
from opencl_path_tracer_tpu.ops.pallas import intersect_kernel as jk
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.types import Rays
from opencl_path_tracer_tpu_torch.models import megakernel
from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k
from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

GOLDENS = [
    ("cornell_16x16_i2_s4", dict(with_spheres=False), 2),
    ("cornell_spheres_16x16_i4_s4", dict(with_spheres=True), 4),
    ("cornell_analytic_16x16_i2_s4",
     dict(with_spheres=True, analytic_spheres=True), 2),
]


def rand_scene(t, seed=0, spread=10.0):
    """The random scene of tests/test_plucker.py, for both packages."""
    rs = np.random.default_rng(seed)
    centers = rs.uniform(-spread, spread, size=(t, 1, 3))
    v = (centers + rs.normal(size=(t, 3, 3)) * 0.6).astype(np.float32)
    args = (v[:, 0], v[:, 1], v[:, 2], np.arange(t, dtype=np.int32) % 7)
    return JTris.build(*args), TrianglesSoA.build(*args)


def rand_rays(n, seed=1, spread=12.0):
    rs = np.random.default_rng(seed)
    p = rs.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p, d


def cornell_rays(w=16, h=16):
    """Camera rays of the Cornell box, (N, 3) origins and directions."""
    cam = jlib.cornell_camera(w, h)
    n = w * h
    rays = jraygen.camera_rays(cam, jraygen.pixel_ids_like(n),
                               jnp.full((n,), 0.3, jnp.float32),
                               jnp.full((n,), 0.7, jnp.float32))
    return (np.stack([np.asarray(c) for c in rays.p], 1),
            np.stack([np.asarray(c) for c in rays.d], 1))


def rays8_both(p, d, tr):
    """The same rays as a JAX (8, Rpad) pack and a port (8, R) pack."""
    r = p.shape[0]
    j8 = jk.pack_rays(tuple(jnp.asarray(p[:, c]) for c in range(3)),
                      tuple(jnp.asarray(d[:, c]) for c in range(3)),
                      -(-r // tr) * tr)
    return j8, torch.from_numpy(np.asarray(j8)[:, :r].copy())


def _case(name):
    if name == "cornell":
        return (jlib.cornell_box(with_spheres=True).tris,
                library.cornell_box(with_spheres=True).tris) + cornell_rays()
    t, n = {"t60": (60, 300), "t700": (700, 500)}[name]
    return rand_scene(t) + rand_rays(n)


@pytest.mark.parametrize("name", ["t60", "t700", "cornell"])
def test_dense_bit_equal_to_interpret_kernel(name):
    jtris, ptris, p, d = _case(name)
    r = p.shape[0]
    j8, p8 = rays8_both(p, d, 128)
    jpack = jk.build_tri_pack(jtris, 1024)
    jout = [np.asarray(o)[:r] for o in jk._run(
        j8, jpack, 128, min(1024, jpack.shape[0]), True, 256)]
    got = [o.numpy() for o in k.dense(p8, k.build_tri_pack(ptris))]
    for what, a, b in zip(("t", "index", "nx", "ny", "nz", "mati"), got, jout):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=what)
    hit = jout[0] < k.BIG
    assert 0 < hit.sum() < r or name == "cornell"
    # Miss lanes latch the first row's attributes (index 0).
    assert (got[1][~hit] == 0).all()


def test_pallas_first_intersect_and_column_slice():
    jtris, ptris, p, d = _case("t700")
    j8, p8 = rays8_both(p, d, 128)
    jh = jk.make_pallas_intersect(jtris, tr=128, interpret=True)(
        _jrays(p, d))
    ph = k.make_pallas_intersect(ptris)(Rays(
        p=tuple(torch.from_numpy(p[:, c].copy()) for c in range(3)),
        d=tuple(torch.from_numpy(d[:, c].copy()) for c in range(3))))
    np.testing.assert_array_equal(ph.t.numpy(), np.asarray(jh.t))
    np.testing.assert_array_equal(ph.mati.numpy(), np.asarray(jh.mati))
    for c in range(3):
        np.testing.assert_array_equal(ph.n[c].numpy(), np.asarray(jh.n[c]))
        np.testing.assert_array_equal(ph.p[c].numpy(), np.asarray(jh.p[c]))
    # A column slice of a wider pack is read in place.
    wide = torch.zeros((8, p8.shape[1] + 40))
    wide[:, 20:20 + p8.shape[1]] = p8
    view = wide[:, 20:20 + p8.shape[1]]
    assert not view.is_contiguous()
    pack = k.build_tri_pack(ptris)
    assert torch.equal(torch.stack(k.dense(view, pack)),
                       torch.stack(k.dense(p8, pack)))


def test_dense_hit_rows_written_into_a_column_slice():
    """With `out`, K4 writes the fused pipeline's hit rows [t (-1 on a
    miss), nx, ny, nz, mati, 0] into a column slice and leaves the other
    columns alone (JAX pipeline.py:99-128 merges them the same way)."""
    jtris, ptris, p, d = _case("t700")
    j8, p8 = rays8_both(p, d, 128)
    r = p.shape[0]
    jpack = jk.build_tri_pack(jtris, 1024)
    jout = [np.asarray(o)[:r] for o in jk._run(
        j8, jpack, 128, min(1024, jpack.shape[0]), True, 256)]
    h = torch.full((6, r + 40), 7.0)
    got = k.dense(p8, k.build_tri_pack(ptris), out=h[:, 20:20 + r])
    assert got.data_ptr() == h[:, 20:].data_ptr()
    want = np.stack([np.where(jout[0] < k.BIG, jout[0], -1.0), *jout[2:6],
                     np.zeros(r, np.float32)]).astype(np.float32)
    np.testing.assert_array_equal(h[:, 20:20 + r].numpy().view(np.int32),
                                  want.view(np.int32))
    assert (h[:, :20] == 7.0).all() and (h[:, 20 + r:] == 7.0).all()
    assert (h[0, 20:20 + r] == -1.0).any() and (h[0, 20:20 + r] > 0).any()


def _jrays(p, d):
    from opencl_path_tracer_tpu.core.types import Rays as JRays
    return JRays(p=tuple(jnp.asarray(p[:, c]) for c in range(3)),
                 d=tuple(jnp.asarray(d[:, c]) for c in range(3)))


@pytest.mark.parametrize("name,kw,iterations", GOLDENS,
                         ids=[g[0] for g in GOLDENS])
def test_pallas_accel_goldens(name, kw, iterations):
    scene = library.cornell_box(**kw)
    cam = library.cornell_camera(16, 16)
    st = megakernel.render(cam, scene.mats,
                           intersect_fn=make_intersect_fn(scene, "pallas"),
                           num_pixels=256, iterations=iterations, spp=4,
                           mode="parity", device="cpu")
    img = megakernel.colors_array(st).numpy()
    golden = np.load(f"tests/golden/{name}.npy")
    np.testing.assert_allclose(img.reshape(16, 16, 3),
                               golden[3:].reshape(16, 16, 3), rtol=1e-4,
                               atol=1e-6)


def test_dense_wrapper_checks_and_cpu_counts_no_launch():
    _, ptris = rand_scene(20)
    pack = k.build_tri_pack(ptris)
    before = dict(_build.launches)
    k.dense(torch.zeros((8, 10)), pack)
    assert _build.launches == before
    with pytest.raises(ValueError):
        k.dense(torch.zeros((6, 10)), pack)
    with pytest.raises(TypeError):
        k.dense(torch.zeros((8, 10), dtype=torch.float64), pack)
    with pytest.raises(ValueError):
        k.dense(torch.zeros((10, 8)).t(), pack)        # rows not contiguous
    with pytest.raises(ValueError):
        k.dense(torch.zeros((8, 10)), pack[:0])
    with pytest.raises(ValueError):
        k.dense(torch.zeros((8, 10)), pack, out=torch.zeros((6, 9)))
    with pytest.raises(ValueError):
        k.dense(torch.zeros((8, 10)), pack, out=torch.zeros((5, 10)))


def _tie_scene():
    """A pack whose rows 300-599 repeat rows 0-299 (every hit there has an
    exact-t tie 300 rows later) and whose rows 600-699 are other
    triangles, some nearer; rays from the random scene's box, 20 that
    point away from everything and 4 zero rays (the padding K4 meets)."""
    _, a = rand_scene(300, seed=3)
    _, b = rand_scene(100, seed=4)
    pa, pb = k.build_tri_pack(a), k.build_tri_pack(b)
    pack = torch.cat([pa, pa, pb])
    p, d = rand_rays(600, seed=5)
    p = np.concatenate([p, np.full((20, 3), 50.0, np.float32),
                        np.zeros((4, 3), np.float32)])
    d = np.concatenate([d, np.full((20, 3), 3 ** -0.5, np.float32),
                        np.zeros((4, 3), np.float32)])
    return rays8_both(p, d, 128)[1], pack


def _chunked(rays8, pack, bounds):
    """K4's split rule on the plain version: minarg_plain over each chunk
    [lo, hi), the index offset by lo (a miss too, as the kernel does),
    combined in chunk order with a strict <; then dense_plain's fetch."""
    t = torch.full((rays8.shape[1],), k.BIG)
    g = torch.zeros(rays8.shape[1])
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        tc, gc = k.minarg_plain(rays8, pack[lo:hi])
        bet = tc < t
        t, g = torch.where(bet, tc, t), torch.where(bet, gc + lo, g)
    rows = pack[g.long()]
    return (t, g, rows[:, 0] + 0.0, rows[:, 1] + 0.0, rows[:, 2] + 0.0,
            rows[:, 16] + 0.0)


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_chunked_combine_equals_whole_dense(splits):
    """The rule the split K4 relies on: per-chunk first-index minima,
    combined in chunk order with a strict <, are dense_plain over the
    whole pack, at chunk bounds that are not tile multiples, with exact-t
    ties across chunk boundaries, all-miss rays and winners in the last
    chunk."""
    rays8, pack = _tie_scene()
    t_all = pack.shape[0]
    bounds = [0] + [t_all * j // splits + 13 for j in range(1, splits)] + [
        t_all]
    assert all(b % 256 for b in bounds[1:-1])
    got = _chunked(rays8, pack, bounds)
    want = k.dense_plain(rays8, pack)
    for what, a, b in zip(("t", "index", "nx", "ny", "nz", "mati"), got,
                          want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), what
    t, g = want[0], want[1].long()
    hit = t < k.BIG
    assert not hit[-24:].any() and (g[-24:] == 0).all()
    # Ties: each winner below row 300 has its twin 300 rows on; the
    # twin lies in a later chunk for some of them.
    twin = hit & (g < 300)
    assert twin.sum() > 20
    chunk_of = torch.bucketize(g, torch.tensor(bounds[1:-1]), right=True)
    twin_chunk = torch.bucketize(g + 300, torch.tensor(bounds[1:-1]),
                                 right=True)
    assert splits == 1 or bool((twin & (twin_chunk > chunk_of)).any())
    assert bool((hit & (g >= max(bounds[-2], 600))).any())


@pytest.mark.parametrize("n_rays,n_tris,sms,want", [
    (2_073_600, 804, 132, 1),       # cornell camera rays
    (2_073_600, 99_380, 132, 1),    # stress camera rays
    (76_800, 804, 132, 4),          # the fused pipeline's exact slice
    (16_384, 99_380, 132, 65),      # the stress tails
    (8_192, 99_380, 132, 130),      # the 'pairwin' tail
    (300, 20_000, 132, 79),         # tests/test_torch_cuda.py's split
    (300, 3_000, 132, 12),          # one tile a chunk
    (1_081_344, 99_380, 132, 1),    # 32 blocks per SM: no split
    (200, 200, 132, 1),             # one tile: no split
    (1, 1, 132, 1),
])
def test_dense_splits(n_rays, n_tris, sms, want):
    """K4's launch shape: whole tiles per chunk, chunks covering the pack
    with none empty, one split where the rays alone make 32 blocks per
    SM, and at most one chunk per tile."""
    splits, chunk = k.dense_splits(n_rays, n_tris, sms)
    assert splits == want
    assert (splits - 1) * chunk < n_tris <= splits * chunk
    if splits > 1:
        assert chunk % 256 == 0
        assert -(-n_rays // 256) * (splits - 1) < 32 * sms or chunk == 256
    else:
        assert chunk == n_tris


def test_dense_split_bounds_equal_whole_dense():
    """The chunks dense_splits gives 300 rays against 3,000 triangles,
    combined as the kernel does, equal dense_plain."""
    _, tris = rand_scene(3000, seed=6)
    pack = k.build_tri_pack(tris)
    rays8 = rays8_both(*rand_rays(300, seed=7), 128)[1]
    splits, chunk = k.dense_splits(300, 3000, 132)
    bounds = [min(j * chunk, 3000) for j in range(splits + 1)]
    assert splits == 12
    for a, b in zip(_chunked(rays8, pack, bounds), k.dense_plain(rays8, pack)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
