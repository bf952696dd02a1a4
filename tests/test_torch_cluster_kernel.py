"""The Morton cluster packs and K17 (`accel='cluster'`) in the port against
the JAX package's `cluster_kernel`: `build_clusters` bit-equal (boxes and
tri_pack, with and without split_large) on cornell_box, stress_scene(1200)
and random triangles; the JAX packs carried across by `interop`; the
per-tile cluster lists (`_tile_cluster_lists`: ids, cnt, entry)
bit-equal; K17's plain version bit-equal to interpret-mode `_run` (t,
winner index, normal, mati) on the JAX packs for tr 256 with 1 and 2
subtiles, early exit off and on; and `make_cluster_intersect`'s Hits
bit-equal to JAX's on `tests/test_pallas.py`'s cornell rays and an odd
ray count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.core.geometry import TrianglesSoA as JTris
from opencl_path_tracer_tpu.core.types import Rays as JRays
from opencl_path_tracer_tpu.ops.pallas import cluster_kernel as jck
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import interop
from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.types import Rays
from opencl_path_tracer_tpu_torch.ops import raygen, rng
from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _rand_tris(t, seed=0, spread=50.0):
    """`tests/test_sorted_intersect.py::_rand_tris`, for both packages."""
    rs = np.random.default_rng(seed)
    centers = rs.uniform(-spread, spread, size=(t, 1, 3))
    verts = (centers + rs.normal(size=(t, 3, 3)) * 1.2).astype(np.float32)
    mati = np.arange(t, dtype=np.int32) % 7
    return (JTris.build(verts[:, 0], verts[:, 1], verts[:, 2], mati),
            TrianglesSoA.build(verts[:, 0], verts[:, 1], verts[:, 2], mati))


SCENES = {
    "cornell": lambda: (jlib.cornell_box(with_spheres=True).tris,
                        library.cornell_box(with_spheres=True).tris),
    "stress": lambda: (jlib.stress_scene(1200).tris,
                       library.stress_scene(1200).tris),
    "random": lambda: _rand_tris(900),
}


def _both_rays(p, d):
    return (JRays.make(jnp.asarray(p), jnp.asarray(d)),
            Rays(p=tuple(torch.from_numpy(p[:, k].copy()) for k in range(3)),
                 d=tuple(torch.from_numpy(d[:, k].copy()) for k in range(3))))


def _camera_rays(w=64, h=64):
    """The cornell camera's rays (coherent tiles), (N, 3) numpy each."""
    cam = library.cornell_camera(w, h)
    s1, r1 = rng.lehmer_step(rng.seed_pixel_streams(w * h, 1))
    _, r2 = rng.lehmer_step(s1)
    rays = raygen.camera_rays(cam, raygen.pixel_ids(w, h, "cpu"), r1, r2)
    return (np.stack([x.numpy() for x in rays.p], 1),
            np.stack([x.numpy() for x in rays.d], 1))


def _random_rays(n, seed):
    rs = np.random.default_rng(seed)
    p = rs.uniform(-90.0, 990.0, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[: n // 8, 0] = 0.0      # direction components of exactly zero
    return p, d


def _aimed_rays(tris, n_tiles=4, seed=6):
    """Tiles of 256 rays from 30 units in front of a small triangle,
    aimed at it: their hits are near, so the early exit stops them before
    the far clusters of their lists."""
    rs = np.random.default_rng(seed)
    r1, r2, r3, nn = (getattr(tris, f).numpy() for f in ("r1", "r2", "r3",
                                                         "n"))
    mid = (r1 + r2 + r3) / 3
    diag = np.linalg.norm(np.maximum(np.maximum(r1, r2), r3)
                          - np.minimum(np.minimum(r1, r2), r3), axis=1)
    ps, ds = [], []
    for t in rs.choice(np.nonzero(diag < np.median(diag))[0], n_tiles,
                       replace=False):
        o = mid[t] + nn[t] * 30.0 + rs.normal(size=(256, 3)) * 2.0
        d = mid[t] + rs.normal(size=(256, 3)) * 2.0 - o
        ps.append(o)
        ds.append(d / np.linalg.norm(d, axis=1, keepdims=True))
    return (np.concatenate(ps).astype(np.float32),
            np.concatenate(ds).astype(np.float32))


def _rows8(p, d):
    r8 = np.zeros((len(p), 8), np.float32)
    r8[:, 0:3], r8[:, 3:6] = p, d
    return r8


@pytest.mark.parametrize("split_large", [False, True])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_build_clusters_bit_equal(scene, split_large):
    jt, pt = SCENES[scene]()
    for cs in ((128, 512) if split_large else (128,)):
        js, jc, jk = jck.build_clusters(jt, cs, split_large=split_large)
        ps, pc, pk = ck.build_clusters(pt, cs, split_large=split_large)
        assert (pc, pk) == (jc, jk)
        np.testing.assert_array_equal(_bits(ps.boxes.numpy()),
                                      _bits(js.boxes))
        np.testing.assert_array_equal(_bits(ps.tri_pack.numpy()),
                                      _bits(js.tri_pack))
    rows = ps.rows()
    assert rows.shape == (pc * pk, 24)
    assert torch.equal(rows[pk + 3], ps.tri_pack[1, :, 3])


def test_split_large_puts_the_walls_first():
    """On cornell the scene-spanning walls fill the leading cluster."""
    _, pt = SCENES["cornell"]()
    plain, _, _ = ck.build_clusters(pt, 128)
    split, c, _ = ck.build_clusters(pt, 128, split_large=True)
    ext = (split.boxes[:, 3:6] - split.boxes[:, 0:3]).amax(1)
    assert float(ext[0]) > 900.0 and float(ext[1:].max()) < float(ext[0])
    assert not torch.equal(plain.tri_pack, split.tri_pack) and c == 7


def test_interop_cluster_scene_round_trip():
    jt, pt = SCENES["stress"]()
    js, _, _ = jck.build_clusters(jt, 128, split_large=True)
    carried = interop.cluster_scene_from_numpy(np.asarray(js.boxes),
                                               np.asarray(js.tri_pack))
    own, _, _ = ck.build_clusters(pt, 128, split_large=True)
    assert torch.equal(carried.boxes, own.boxes)
    assert torch.equal(carried.tri_pack, own.tri_pack)
    back = interop.cluster_scene_to_numpy(carried)
    np.testing.assert_array_equal(_bits(back["boxes"]), _bits(js.boxes))
    np.testing.assert_array_equal(_bits(back["tri_pack"]),
                                  _bits(js.tri_pack))
    assert back["tri_pack"].dtype == np.float32


@pytest.mark.parametrize("rays", ["camera", "random"])
def test_tile_cluster_lists_bit_equal(rays):
    p, d = _camera_rays() if rays == "camera" else _random_rays(4096, 2)
    jt, pt = SCENES["stress"]()
    js, _, _ = jck.build_clusters(jt, 128)
    ps, _, _ = ck.build_clusters(pt, 128)
    r8 = _rows8(p, d)
    jids, jcnt, jent = jck._tile_cluster_lists(jnp.asarray(r8), js.boxes,
                                               256)
    pids, pcnt, pent = ck._tile_cluster_lists(torch.from_numpy(r8), ps.boxes,
                                              256)
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(pcnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(_bits(pent.numpy()), _bits(jent))
    if rays == "camera":
        # Coherent tiles pass only some of the clusters.
        assert int(pcnt.min()) < ps.boxes.shape[0]


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("subtiles", [1, 2])
def test_k17_plain_bit_equal_to_interpret_mode(subtiles, early_exit):
    """K17 on the JAX packs (carried by interop) and the JAX tile lists:
    the cornell camera rays, rays aimed at small triangles (the early exit
    stops them) and random rays, 4 tiles of 256 each."""
    jt, pt = SCENES["cornell"]()
    js, c, k = jck.build_clusters(jt, 128)
    cs = interop.cluster_scene_from_numpy(np.asarray(js.boxes),
                                          np.asarray(js.tri_pack))
    cp, cd = _camera_rays(32, 32)
    ap, ad = _aimed_rays(pt)
    rp, rd = _random_rays(1024, 3)
    r8 = _rows8(np.concatenate([cp, ap, rp]), np.concatenate([cd, ad, rd]))
    ids, cnt, ent = jck._tile_cluster_lists(jnp.asarray(r8), js.boxes, 256)
    jout = jck._run(jnp.asarray(r8), cnt, ids, ent, js.tri_pack, 256,
                    subtiles, early_exit, True)
    pout = ck.run_cluster(torch.from_numpy(r8), torch.tensor(np.array(cnt)),
                          torch.tensor(np.array(ids)),
                          torch.tensor(np.array(ent)), cs.rows(), k, 256,
                          early_exit)
    for a, b in zip(pout, jout):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    hit = pout[0] < ck.BIG
    assert 0.5 < float(hit.float().mean()) < 1.0
    assert int(pout[1].max()) < c * k
    # The aimed tiles' lists hold clusters beyond their farthest hit.
    far = pout[0].view(-1, 256).amax(1)
    cnt_t = torch.tensor(np.array(cnt))[:, 0]
    ent_t = torch.tensor(np.array(ent))
    stops = [int((ent_t[g, :cnt_t[g]] >= far[g]).sum()) for g in (4, 5, 6, 7)]
    assert min(stops) > 0


def _cornell_test_rays(n=600, seed=11):
    """`tests/test_pallas.py::test_cluster_kernel_on_cornell`'s rays."""
    rs = np.random.default_rng(seed)
    p = (rs.uniform(-12, 12, size=(n, 3)) * 40
         + np.asarray([500.0, 500.0, 100.0])).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return p, d


@pytest.mark.parametrize("case", ["cornell600", "odd777", "camera"])
def test_make_cluster_intersect_bit_equal(case):
    jt, pt = SCENES["cornell"]()
    if case == "cornell600":
        p, d = _cornell_test_rays()
    elif case == "odd777":
        p, d = _random_rays(777, 4)
    else:
        p, d = _camera_rays(32, 24)
    jr, pr = _both_rays(p, d)
    kw = dict(early_exit=True) if case == "camera" else {}
    jh = jck.make_cluster_intersect(jt, interpret=True, **kw)(jr)
    ph = ck.make_cluster_intersect(pt, **kw)(pr)
    np.testing.assert_array_equal(_bits(ph.t.numpy()), _bits(jh.t))
    np.testing.assert_array_equal(ph.mati.numpy(), np.asarray(jh.mati))
    for k in range(3):
        np.testing.assert_array_equal(_bits(ph.p[k].numpy()), _bits(jh.p[k]))
        np.testing.assert_array_equal(_bits(ph.n[k].numpy()), _bits(jh.n[k]))
    assert float((ph.t > 0).float().mean()) > 0.5


def test_run_cluster_checks_its_inputs():
    _, pt = SCENES["cornell"]()
    ps, c, k = ck.build_clusters(pt, 128)
    r8 = torch.zeros((300, 8))
    g = 1
    cnt = torch.zeros((g, 1), dtype=torch.int32)
    ids = torch.zeros((g, c), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of"):
        ck.run_cluster(r8, cnt, ids, torch.zeros((g, c)), ps.rows(), k, 256)
    with pytest.raises(ValueError, match="clusters of"):
        ck.run_cluster(r8[:256], cnt, ids, torch.zeros((g, c)),
                       ps.rows()[:-1], k, 256)
