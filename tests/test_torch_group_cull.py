"""K16 with the sub-block skip rule (csrc/group.cu), on the CPU.

The kernel walks each ray's block union in ascending cluster order, as
the first kernel did, and skips, per ray, each sub-block of SUB rows
whose box its segment to its running best misses, where the first kernel
ran all K rows. A mirror of that loop (tests/sub_cull_mirror.py) must
give `group_plain`'s rows (t, nx, ny, nz, mati) bit for bit on the camera
rays and the bounce-1 and bounce-2 rays of the Cornell box and of the
reference scene, mask-sorted by `group_inputs` as the 'group' accel does
(blocks of 2,048, and of 96, which straddle the kernel's warps), and the
winner rows of the walk that skips nothing. Padding rays (D = 0) take no
cluster. The table follows the clusters, the rows of zero-area triangles
lie in sub-blocks that are never skipped, and the wrapper refuses a
missing or short table.
"""

import pathlib

import numpy as np
import pytest
import torch

from sub_cull_mirror import SUB, mirrored_group, never_skipped
from opencl_path_tracer_tpu_torch.ops import raygen, rng
from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
from opencl_path_tracer_tpu_torch.runtime.cull_ab import _bounce
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

MODELS = str(pathlib.Path(__file__).resolve().parent / "assets" / "models")
W, H = 16, 16
_CACHE = {}


def scene_and_camera(name):
    """(scene, camera, cluster scene, C, K, rows, table) as the 'group'
    accel builds them."""
    if name not in _CACHE:
        if name == "cornell":
            sc = library.cornell_box(with_spheres=True)
            cam = library.cornell_camera(W, H)
        else:
            sc = library.reference_scene(MODELS, smooth=True)
            cam = library.reference_camera(W, H)
        cscene, c, k = ck.build_clusters(sc.tris, 128, split_large=True)
        rows = cscene.rows()
        _CACHE[name] = (sc, cam, cscene, c, k, rows,
                        ck.cluster_sub_boxes(rows, k))
    return _CACHE[name]


def group_batch(name, bounce, block):
    """(union, rays8 (Rpad, 8)): the camera rays after `bounce` bounces,
    mask-sorted in blocks of `block` by `group_inputs`."""
    sc, cam, cscene, *_ = scene_and_camera(name)
    s1, u1 = rng.lehmer_step(rng.seed_pixel_streams(W * H, 1))
    _, u2 = rng.lehmer_step(s1)
    rays = raygen.camera_rays(cam, raygen.pixel_ids(W, H, "cpu"), u1, u2)
    for _ in range(bounce):
        rays = _bounce(sc, cam, rays)
    _, union, rr8 = si.group_inputs(rays, cscene.boxes, block)
    return union, rr8


@pytest.mark.parametrize("block", [2048, 96])
@pytest.mark.parametrize("bounce", [0, 1, 2])
@pytest.mark.parametrize("name", ["cornell", "reference"])
def test_mirrored_loop_equals_group_plain(name, bounce, block):
    _, _, _, c, k, rows, sub = scene_and_camera(name)
    union, rr8 = group_batch(name, bounce, block)
    plain = si.group_plain(union, rr8, rows, k, block)
    counts = {}
    for coop in (-1, 16, 32):
        t, g, n_div, n_box, n_made = mirrored_group(
            union.numpy(), rr8.numpy(), rows, k, block, sub.numpy(), coop)
        out = torch.stack([torch.from_numpy(t), *ck.winner_attrs(
            rows, torch.from_numpy(g), torch.from_numpy(t < k1.BIG))])
        assert torch.equal(out, plain), coop
        counts[coop] = (n_div, n_box, n_made)
    assert counts[-1] == counts[16] == counts[32]
    assert 10 < int((plain[0] < k1.BIG).sum())
    # The rule is not vacuous: under half of the first kernel's tests
    # (every ray against all K rows of each cluster of its union) reach
    # the divide.
    bits = sum(int(((union >> b) & 1).sum()) for b in range(c))
    assert 0 < counts[16][0] < 0.5 * bits * block * k


@pytest.mark.parametrize("name", ["cornell", "reference"])
def test_skipping_changes_no_bit_against_the_first_walk(name):
    """The winner rows equal those of the walk that skips nothing (the
    first kernel's, every row of every cluster of the union), even for
    clusters of the union that the ray's own mask does not have; padding
    rays (D = 0) take no cluster."""
    _, _, _, c, k, rows, sub = scene_and_camera(name)
    union, rr8 = group_batch(name, 1, 2048)
    u, r = union.numpy(), rr8.numpy()
    a = mirrored_group(u, r, rows, k, 2048, sub.numpy(), 16)
    b = mirrored_group(u, r, rows, k, 2048, never_skipped(sub.shape[0]), -1)
    assert np.array_equal(a[0].view(np.int32), b[0].view(np.int32))
    assert np.array_equal(a[1], b[1]) and a[2] < b[2]
    pad = ~(r[:, 3:6] != 0).any(1)
    assert pad.sum() == r.shape[0] - W * H
    bits = np.repeat(u.astype(np.int64), 2048)
    n_take = sum(int((((bits >> ci) & 1) == 1)[~pad].sum())
                 for ci in range(c))
    assert b[4] == n_take * -(-k // SUB)


@pytest.mark.parametrize("name", ["cornell", "reference"])
def test_table_follows_the_clusters(name):
    _, _, _, c, k, rows, sub = scene_and_camera(name)
    nsb = -(-k // SUB)
    assert sub.shape == (c * nsb, 8)
    parts = [ck.sub_boxes(rows[i * k:(i + 1) * k], [(0, k)]).numpy()
             for i in range(c)]
    assert np.array_equal(sub.numpy(), np.concatenate(parts))


def test_zero_area_rows_are_never_skipped():
    sc, _, _, c, k, rows, sub = scene_and_camera("reference")
    r1, r2, r3 = (getattr(sc.tris, f).double() for f in ("r1", "r2", "r3"))
    zero = torch.linalg.cross(r2 - r1, r3 - r1).norm(dim=1) == 0.0
    assert int(zero.sum()) == 20            # Wineglass.obj's
    pack = k1.build_tri_pack(sc.tris)
    nsb = -(-k // SUB)
    sub = sub.numpy()
    n_left_out = 0
    for z in torch.nonzero(zero).flatten().tolist():
        if not pack[z, 0:3].any():          # n = 0: never accepted
            n_left_out += 1
            continue
        at = torch.nonzero((rows == pack[z]).all(1)).flatten().tolist()
        assert at, z
        for row in at:
            sb = (row // k) * nsb + (row % k) // SUB
            assert np.isneginf(sub[sb, 0:3]).all() and np.isposinf(
                sub[sb, 3])
    assert n_left_out < 20


def test_wrappers_take_the_table():
    _, _, _, c, k, rows, sub = scene_and_camera("cornell")
    union, rr8 = group_batch("cornell", 0, 2048)
    plain = si.run_group(union, rr8, rows, k, 2048)
    assert all(torch.equal(a, b) for a, b in zip(
        si.run_group(union, rr8, rows, k, 2048, sub), plain))
    for fn in (lambda: si.run_group_simt(union, rr8, rows, k, 2048),
               lambda: si.run_group_counted(union, rr8, rows, k, 2048, sub)):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fn()
    with pytest.raises(ValueError, match="sub has shape"):
        si.run_group_counted(union, rr8, rows, k, 2048, sub[:-1])
