"""K17 with the sub-block skip rule (csrc/cluster.cu), on the CPU, and the
skip rule's span table (`cluster_kernel.sub_boxes`) that K12, K17 and K7
share.

The kernel walks each tile's cluster list in list order and skips, per
ray, each sub-block of SUB rows whose box its segment to its running best
misses. A mirror of that loop (tests/sub_cull_mirror.py: the slab test
with CUDA's directed roundings emulated exactly, K1's exact test, the
lane-wise and warp-wise merges as the kernel's warps choose them) must
give `cluster_plain`'s bits on `stress_scene(1200)`'s clusters of 128 in
tiles of 128, with the early exit off and on, on camera rays, rays aimed
at triangle corners and rays along edges and grazing planes
(tests/march_lanes.py). The table: built from any spans, no sub-block
straddles one, degenerate rows are marked, and K12's table keeps the
bits it had before it was built from spans.
"""

import hashlib

import numpy as np
import pytest
import torch

from march_lanes import aimed_rays, grazing_rays
from sub_cull_mirror import BIG32, SUB, mirrored_tiles
from opencl_path_tracer_tpu_torch.ops import raygen, rng
from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

_CACHE = {}


def scene():
    """stress_scene(1200)'s triangles, clusters of 128, their rows and
    table."""
    if not _CACHE:
        tris = library.stress_scene(1200).tris
        cscene, c, k = ck.build_clusters(tris, 128)
        rows = cscene.rows()
        _CACHE.update(tris=tris, cscene=cscene, c=c, k=k, rows=rows,
                      sub=ck.cluster_sub_boxes(rows, k).numpy())
    return _CACHE


def camera_rays8(w=24, h=16):
    cam = library.cornell_camera(w, h)
    s1, u1 = rng.lehmer_step(rng.seed_pixel_streams(w * h, 1))
    _, u2 = rng.lehmer_step(s1)
    rays = raygen.camera_rays(cam, raygen.pixel_ids(w, h, "cpu"), u1, u2)
    r8 = np.zeros((8, w * h), np.float32)
    for j in range(3):
        r8[j], r8[3 + j] = rays.p[j].numpy(), rays.d[j].numpy()
    return r8


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("kind", ["camera", "aimed", "grazing"])
def test_mirrored_loop_equals_cluster_plain(kind, early_exit):
    d = scene()
    k, rows, sub = d["k"], d["rows"], d["sub"]
    r8 = {"camera": camera_rays8,
          "aimed": lambda: aimed_rays(500, 41, d["tris"]),
          "grazing": lambda: grazing_rays(d["tris"], 500, 42)}[kind]()
    tr = 128
    r = r8.shape[1]
    rr8 = ck.pack_rays_rows(
        [torch.from_numpy(r8[j]) for j in range(3)],
        [torch.from_numpy(r8[j]) for j in range(3, 6)], -(-r // tr) * tr)
    ids, cnt, ent = ck._tile_cluster_lists(rr8, d["cscene"].boxes, tr)
    plain = ck.cluster_plain(rr8, cnt, ids, ent, rows, k, tr,
                             early_exit).numpy()
    listed = int(cnt.sum()) * tr * k
    for coop in (-1, 12, 32):
        t, g, n_div, n_box, n_made = mirrored_tiles(
            rr8.numpy(), cnt.numpy(), ids.numpy(), ent.numpy(), rows, k, tr,
            sub, early_exit, coop)
        assert np.array_equal(t.view(np.int32), plain[0].view(np.int32))
        hit = t < BIG32
        g_out = np.where(hit, g, 0)
        assert np.array_equal(g_out.astype(np.float32), plain[1])
        attrs = rows.numpy()[g_out][:, [0, 1, 2, 16]] + np.float32(0.0)
        attrs[~hit] = 0.0
        assert np.array_equal(attrs.T.view(np.int32),
                              plain[2:].view(np.int32))
        assert hit.sum() > 20
        # The rule is not vacuous: fewer tests than the listed clusters'.
        assert n_div < listed and n_box < n_made


def test_span_table_never_straddles_a_span():
    d = scene()
    rows = d["rows"]
    n = rows.shape[0]
    spans = [(0, 50), (50, 51), (51, 130), (130, 256), (256, n - 7),
             (n - 7, n)]
    table = ck.sub_boxes(rows, spans).numpy()
    sizes = [e - b for b, e in spans]
    assert table.shape == (sum(-(-s // SUB) for s in sizes), 8)
    # Each span's sub-blocks are the table of that span alone: none takes
    # a row of the next.
    parts = [ck.sub_boxes(rows[b:e], [(0, e - b)]).numpy() for b, e in spans]
    assert np.array_equal(table, np.concatenate(parts))
    # The cluster table is the table of the clusters' spans.
    k = d["k"]
    assert np.array_equal(
        ck.cluster_sub_boxes(rows, k).numpy(),
        ck.sub_boxes(rows, [(c * k, (c + 1) * k) for c in range(n // k)])
        .numpy())


# sha256 of K12's table (`pair_sub_boxes`, the rows with the dummy
# cluster) as it was built before the builder took spans.
K12_TABLES = {
    (1200, 128): "95dff4406ec9324c262b3adbdf28f12e"
                 "4280654057f176c15ddb351ea8677bef",
    (1200, 512): "19d0ae39f6cbe8a5bc677ef2fcabb041"
                 "d7c564355b5e763569d7ef5581008e63",
    (6000, 512): "f133ba9e9d83c0b0f3d84758ef198f4e"
                 "57fcbfbea358314df6de26f840d78394",
}


@pytest.mark.parametrize("n_tris,cs", sorted(K12_TABLES))
def test_k12_table_keeps_its_bits(n_tris, cs):
    tris = library.stress_scene(n_tris).tris
    cscene, _, k = ck.build_clusters(tris, cs)
    rows = torch.cat([cscene.rows(), torch.zeros((k, 24))])
    table = si.pair_sub_boxes(rows, k).numpy()
    assert hashlib.sha256(table.tobytes()).hexdigest() == K12_TABLES[
        (n_tris, cs)]


def test_k12_table_with_a_partial_sub_block():
    # Clusters of 100 rows: each ends in a sub-block of 4.
    tris = library.cornell_box(with_spheres=True).tris
    cscene, c, k = ck.build_clusters(tris, 100)
    rows = torch.cat([cscene.rows(), torch.zeros((k, 24))])
    table = si.pair_sub_boxes(rows, k).numpy()
    assert table.shape == ((c + 1) * 4, 8)
    assert hashlib.sha256(table.tobytes()).hexdigest() == (
        "7d8f3148ed7a8293ccf7d50fb1a7fd43240135c17b1fd085e182341b4c08eff2")


def test_span_table_marks_degenerate_rows():
    d = scene()
    rows = d["rows"][:200].clone()
    rows[5] = 0.0                                # n = 0: left out
    rows[40:72] = 0.0                            # a sub-block of n = 0
    rows[100, 4:7] = rows[100, 8:11]             # m1 = m2: no triangle
    rows[150, 0] = 2.0 ** 40                     # outside the ranges
    spans = [(0, 72), (72, 130), (130, 200)]
    t = ck.sub_boxes(rows, spans).numpy()
    # Span 0: rows 0-31 (row 5 left out), 32-63 (40-63 zero), 64-71 (all
    # zero: the empty box, always skipped).
    assert np.isfinite(t[0, 0:3]).all() and np.isfinite(t[1, 0:3]).all()
    assert np.isposinf(t[2, 0:3]).all() and np.isneginf(t[2, 4:7]).all()
    # Span 1 from row 72: row 100 in its first sub-block; row 150 is the
    # 21st of span 2's first.
    assert np.isneginf(t[3, 0:3]).all() and np.isposinf(t[3, 3])
    assert np.isposinf(t[3, 4:7]).all()
    assert np.isfinite(t[4, 0:3]).all()
    assert np.isneginf(t[5, 0:3]).all() and np.isposinf(t[5, 3])
    assert np.isfinite(t[6, 0:3]).all()
    z = ck.sub_boxes(rows, [(40, 72)]).numpy()
    assert np.isposinf(z[0, 0:3]).all() and np.isneginf(z[0, 4:7]).all()


def test_wrappers_take_the_table():
    d = scene()
    k, rows = d["k"], d["rows"]
    r8 = camera_rays8(16, 16)
    rr8 = ck.pack_rays_rows([torch.from_numpy(r8[j]) for j in range(3)],
                            [torch.from_numpy(r8[j]) for j in range(3, 6)],
                            256)
    ids, cnt, ent = ck._tile_cluster_lists(rr8, d["cscene"].boxes, 128)
    sub = ck.cluster_sub_boxes(rows, k)
    # The plain version ignores the table.
    a = ck.run_cluster(rr8, cnt, ids, ent, rows, k, 128, False, sub)
    b = ck.run_cluster(rr8, cnt, ids, ent, rows, k, 128)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="sub has shape"):
        ck.run_cluster(rr8, cnt, ids, ent, rows, k, 128, False, sub[:-1])
    for fn in (lambda: ck.run_cluster_simt(rr8, cnt, ids, ent, rows, k, 128),
               lambda: ck.run_cluster_counted(rr8, cnt, ids, ent, rows, k,
                                              128, False, sub)):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fn()
