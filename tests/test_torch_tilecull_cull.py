"""K6 with the sub-block skip rule (csrc/tilecull.cu), on the CPU.

Inside a group it needs, the kernel skips, per ray, each sub-block of SUB
rows whose box the segment P + s D, 0 <= s <= best t, misses, where the
first kernel ran every row. A mirror of that loop (tests/sub_cull_mirror.py:
the slab test with CUDA's directed roundings emulated exactly, K1's exact
test, the lane-wise and warp-wise merges as the kernel's warps choose
them) must give `tilecull_plain`'s (t, g) bit for bit on the camera rays
and the bounce-1 and bounce-2 rays of the Cornell box and of the reference
scene (whose Wineglass has zero-area triangles), with the groups ordered
front to back from the eye as the 'tilecull' accel builds them, and on
rays with zero, subnormal and huge components. The table follows the
groups, the rows of zero-area triangles lie in sub-blocks that are never
skipped, and the wrapper refuses a missing or short table.
"""

import pathlib

import numpy as np
import pytest
import torch

from sub_cull_mirror import SUB, mirrored_tilecull, never_skipped
from opencl_path_tracer_tpu_torch.ops import raygen, rng
from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.ops.kernels import tilecull_kernel as tk
from opencl_path_tracer_tpu_torch.runtime.cull_ab import _bounce
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

MODELS = str(pathlib.Path(__file__).resolve().parent / "assets" / "models")
W, H = 16, 16
_CACHE = {}


def scene_and_camera(name):
    """(scene, camera, pack, groups, table): the groups as the 'tilecull'
    accel builds them, front to back from the camera's eye."""
    if name not in _CACHE:
        if name == "cornell":
            sc = library.cornell_box(with_spheres=True)
            cam = library.cornell_camera(W, H)
        else:
            sc = library.reference_scene(MODELS, smooth=True)
            cam = library.reference_camera(W, H)
        eye = tuple(float(v) for v in cam.eye)
        pack, groups, _ = tk.grouped_pack(sc.tris, 128, origin=eye)
        _CACHE[name] = (sc, cam, pack, groups,
                        tk.anyhit_sub_boxes(pack, groups))
    return _CACHE[name]


def ray_batch(name, bounce):
    """(8, R) float32: the camera rays after `bounce` bounces."""
    sc, cam, *_ = scene_and_camera(name)
    s1, u1 = rng.lehmer_step(rng.seed_pixel_streams(W * H, 1))
    _, u2 = rng.lehmer_step(s1)
    rays = raygen.camera_rays(cam, raygen.pixel_ids(W, H, "cpu"), u1, u2)
    for _ in range(bounce):
        rays = _bounce(sc, cam, rays)
    return k1.pack_rays(rays.p, rays.d).contiguous()


def special_rays(r8):
    """Every fifth ray with zero, subnormal or huge direction components
    or a huge origin: some out of the rule's ranges (never skipped), some
    with a reciprocal that overflows."""
    r8 = r8.clone()
    sel = r8[:, ::5]
    vals = [(3, 0.0), (4, -0.0), (3, 1e-42), (5, -3e-39), (4, 1e30),
            (0, 3e20), (3, 2e12)]
    for n, (row, v) in enumerate(vals):
        sel[row, n::len(vals)] = v
    sel[3:6, len(vals)::2 * len(vals)] = 0.0            # D = 0
    r8[:, ::5] = sel
    return r8


@pytest.mark.parametrize("bounce", [0, 1, 2])
@pytest.mark.parametrize("name", ["cornell", "reference"])
def test_mirrored_loop_equals_tilecull_plain(name, bounce):
    _, _, pack, groups, sub = scene_and_camera(name)
    r8 = ray_batch(name, bounce)
    tp, gp = (x.numpy() for x in tk.tilecull_plain(r8, pack, groups))
    first = sum(int(e - b) for b, e in groups[:, 6:8].long().tolist())
    counts = {}
    for coop in (-1, 16, 32):
        t, g, n_div, n_box, n_made = mirrored_tilecull(
            r8.numpy(), pack, groups.numpy(), sub.numpy(), coop)
        assert np.array_equal(t.view(np.int32), tp.view(np.int32)), coop
        assert np.array_equal(g, gp.astype(np.int64)), coop
        counts[coop] = (n_div, n_box, n_made)
    assert counts[-1] == counts[16] == counts[32]
    assert 10 < int((tp < k1.BIG).sum())
    # The rule is not vacuous: under half of the rows of the groups reach
    # the divide.
    assert 0 < counts[16][0] < 0.5 * first * r8.shape[1]


@pytest.mark.parametrize("name", ["cornell", "reference"])
def test_mirrored_loop_holds_on_special_rays(name):
    """Zero, subnormal and huge components, D = 0, and a batch whose
    rays outside the rule's ranges (|P| > 2^64, |D| > 2^40) run every
    sub-block of the groups they need."""
    _, _, pack, groups, sub = scene_and_camera(name)
    r8 = special_rays(ray_batch(name, 1))
    tp, gp = (x.numpy() for x in tk.tilecull_plain(r8, pack, groups))
    for coop in (-1, 16):
        t, g, *_ = mirrored_tilecull(r8.numpy(), pack, groups.numpy(),
                                     sub.numpy(), coop)
        assert np.array_equal(t.view(np.int32), tp.view(np.int32))
        assert np.array_equal(g, gp.astype(np.int64))
    huge = r8[:, ::5][:, [5, 6]].contiguous().numpy()     # |P|, |D| huge
    never = mirrored_tilecull(huge, pack, groups.numpy(),
                              never_skipped(sub.shape[0]), 16)
    ruled = mirrored_tilecull(huge, pack, groups.numpy(), sub.numpy(), 16)
    assert ruled[2:] == never[2:] and ruled[2] > 0


@pytest.mark.parametrize("name", ["cornell", "reference"])
def test_skipping_changes_no_bit_against_the_first_walk(name):
    """With a table that skips nothing (the first kernel's walk) the
    mirror gives the same (t, g), and more tests reach the divide."""
    _, _, pack, groups, sub = scene_and_camera(name)
    r8 = ray_batch(name, 2).numpy()
    a = mirrored_tilecull(r8, pack, groups.numpy(), sub.numpy(), 16)
    b = mirrored_tilecull(r8, pack, groups.numpy(),
                          never_skipped(sub.shape[0]), -1)
    assert np.array_equal(a[0].view(np.int32), b[0].view(np.int32))
    assert np.array_equal(a[1], b[1]) and a[2] < b[2]


@pytest.mark.parametrize("name", ["cornell", "reference"])
def test_table_follows_the_groups(name):
    """K6's table: each group's sub-blocks from its base (the last group's
    partial), none taking a row of the next group, for the groups ordered
    front to back."""
    _, _, pack, groups, sub = scene_and_camera(name)
    spans = groups[:, 6:8].long().tolist()
    assert spans[0][0] == 0 and all(
        a[1] == b[0] for a, b in zip(spans, spans[1:]))
    parts = [ck.sub_boxes(pack[b:e], [(0, e - b)]).numpy() for b, e in spans]
    assert np.array_equal(sub.numpy(), np.concatenate(parts))
    assert sub.shape[0] == sum(-(-(e - b) // SUB) for b, e in spans)


def test_zero_area_rows_are_never_skipped():
    sc, cam, pack, groups, sub = scene_and_camera("reference")
    eye = tuple(float(v) for v in cam.eye)
    _, perm, _, spans = tk.build_groups(sc.tris, 128, origin=eye)
    r1, r2, r3 = (getattr(sc.tris, f).double()[perm]
                  for f in ("r1", "r2", "r3"))
    zero = torch.linalg.cross(r2 - r1, r3 - r1).norm(dim=1) == 0.0
    assert int(zero.sum()) == 20            # Wineglass.obj's
    sub = sub.numpy()
    first = np.cumsum([0] + [-(-(e - b) // SUB) for b, e in spans])
    n_left_out = 0
    for row in torch.nonzero(zero).flatten().tolist():
        gi = next(i for i, (b, e) in enumerate(spans) if b <= row < e)
        sb = first[gi] + (row - spans[gi][0]) // SUB
        if not pack[row, 0:3].any():        # n = 0: never accepted
            n_left_out += 1
            continue
        assert np.isneginf(sub[sb, 0:3]).all() and np.isposinf(sub[sb, 3])
    assert n_left_out < 20


def test_wrapper_takes_the_table():
    _, _, pack, groups, sub = scene_and_camera("cornell")
    r8 = ray_batch("cornell", 0)
    plain = tk.tilecull(r8, pack, groups)
    assert all(torch.equal(a, b)
               for a, b in zip(tk.tilecull(r8, pack, groups, sub), plain))
    with pytest.raises(ValueError, match="sub has shape"):
        tk.tilecull(r8, pack, groups, sub[:, :7].contiguous())
    with pytest.raises(ValueError, match="sub has 25 rows"):
        tk.tilecull(r8, pack, groups, sub[:-1])
    with pytest.raises(ValueError, match="sub has 25 rows"):
        tk.anyhit(r8, torch.ones(r8.shape[1]), pack, groups, sub[:-1])
    for fn in (lambda: tk.tilecull_simt(r8, pack, groups),
               lambda: tk.tilecull_counted(r8, pack, groups, sub)):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fn()


def test_intersector_builds_no_table_on_the_cpu():
    """The 'tilecull' accel on CPU tensors takes the plain version; the
    table is built once per scene on the card only."""
    sc, cam, pack, groups, _ = scene_and_camera("cornell")
    r8 = ray_batch("cornell", 0)
    eye = tuple(float(v) for v in cam.eye)
    from opencl_path_tracer_tpu_torch.core.types import Rays
    rays = Rays(p=tuple(r8[j] for j in range(3)),
                d=tuple(r8[j] for j in range(3, 6)))
    hits = tk.make_tilecull_intersect(sc.tris, origin=eye)(rays)
    t, _ = tk.tilecull_plain(r8, pack, groups)
    hit = t < k1.BIG
    assert torch.equal(hits.t > 0, hit) and torch.equal(hits.t[hit], t[hit])
