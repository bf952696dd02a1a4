"""K14 and K15 with the sub-block skip rule (csrc/minarg_fused.cu,
csrc/mxu.cu), on the CPU.

Per ray the kernels walk the pack's sub-blocks of SUB rows in row order
and skip each one whose box (`cluster_kernel.sub_boxes` over the one span
[0, T)) the segment P + s D, 0 <= s <= best, misses, where the first
kernels ran every row; K15, whose best starts at +inf and whose rows that
do not accept a ray compete with BIG, skips nothing while its best is
above BIG. A mirror of that loop (tests/sub_cull_mirror.py: the slab test
with CUDA's directed roundings emulated exactly, K1's or K15's exact
test, the lane-wise and warp-wise merges as the kernels' warps choose
them) must give `minarg_fused_plain`'s or `mxu_plain`'s outputs bit for
bit on the camera and first-bounce rays of the Cornell box and of the
reference scene (whose Wineglass has zero-area triangles) at 32x18, and on
a crafted batch: exact-t ties across sub-blocks, rows accepted above BIG,
-0.0 normals, D = 0 rays, T = 1, 31, 33 and 804. A table that skips
nothing gives the same bits with more tests, and the wrappers refuse a
table of the wrong length.
"""

import pathlib

import numpy as np
import pytest
import torch

from sub_cull_mirror import (
    ABOVE_BIG_CASES, BIG32, CRAFTED_CASES, DEGENERATE_C0, SUB, box_maybe,
    crafted_dense, cull_ray, dense_tests, mirrored_dense, never_skipped,
)
from opencl_path_tracer_tpu_torch.core.types import Rays
from opencl_path_tracer_tpu_torch.ops import raygen, rng
from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.ops.kernels import plucker_kernel as k2
from opencl_path_tracer_tpu_torch.runtime.cull_ab import _bounce
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

MODELS = str(pathlib.Path(__file__).resolve().parent / "assets" / "models")
W, H = 32, 18
KERNELS = ("minarg_fused", "mxu")
PLAIN = {"minarg_fused": k2.minarg_fused_plain, "mxu": k1.mxu_plain}
TEST = {"minarg_fused": "k1", "mxu": "mxu"}
_CACHE = {}


def scene_and_camera(name):
    """(scene, camera, pack, table): the pack as the intersectors build it,
    the table over its one span."""
    if name not in _CACHE:
        if name == "cornell":
            sc = library.cornell_box(with_spheres=True)
            cam = library.cornell_camera(W, H)
        else:
            sc = library.reference_scene(MODELS, smooth=True)
            cam = library.reference_camera(W, H)
        pack = k1.build_tri_pack(sc.tris)
        _CACHE[name] = (sc, cam, pack,
                        ck.sub_boxes(pack, [(0, pack.shape[0])]))
    return _CACHE[name]


def ray_batch(name, bounce):
    """(8, R) float32: the camera rays after `bounce` bounces."""
    if (name, bounce) not in _CACHE:
        sc, cam, *_ = scene_and_camera(name)
        s1, u1 = rng.lehmer_step(rng.seed_pixel_streams(W * H, 1))
        _, u2 = rng.lehmer_step(s1)
        rays = raygen.camera_rays(cam, raygen.pixel_ids(W, H, "cpu"), u1,
                                  u2)
        for _ in range(bounce):
            rays = _bounce(sc, cam, rays)
        _CACHE[name, bounce] = k1.pack_rays(rays.p, rays.d).contiguous()
    return _CACHE[name, bounce]


def outputs(kernel, pack, bt, bg):
    """The kernel's outputs from the mirror's (t, winner row)."""
    g = torch.from_numpy(bg)
    rows = pack[g]
    attrs = tuple(rows[:, c] + 0.0 for c in (0, 1, 2, 16))
    t = torch.from_numpy(bt)
    if kernel == "minarg_fused":
        return (torch.where(t < k1.BIG, t, torch.full_like(t, -1.0)),
                *attrs)
    return (t, g.to(torch.float32), *attrs)


def bits_equal(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def mirror(kernel, r8, pack, sub, coop, tested=None):
    bt, bg, *counts = mirrored_dense(r8.numpy(), pack, sub, coop,
                                     TEST[kernel], tested)
    return outputs(kernel, pack, bt, bg), counts


@pytest.mark.parametrize("bounce", [0, 1])
@pytest.mark.parametrize("name", ["cornell", "reference"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_mirrored_loop_equals_plain(kernel, name, bounce):
    _, _, pack, sub = scene_and_camera(name)
    r8 = ray_batch(name, bounce)
    plain = PLAIN[kernel](r8, pack)
    tested = dense_tests(r8.numpy(), pack, TEST[kernel])
    counts = {}
    for coop in (-1, 16, 32):
        got, counts[coop] = mirror(kernel, r8, pack, sub.numpy(), coop,
                                   tested)
        assert bits_equal(got, plain), coop
    assert counts[-1] == counts[16] == counts[32]
    n_div, n_box, n_made = counts[16]
    r = r8.shape[1]
    assert n_made == r * sub.shape[0] and n_box <= n_made
    assert 10 < int((plain[0] > 0.0).sum() if kernel == "minarg_fused"
                    else (plain[0] < k1.BIG).sum())
    # The rule is not vacuous: under a fifth of the (ray, row) tests reach
    # the divide.
    assert 0 < n_div < 0.2 * pack.shape[0] * r


@pytest.mark.parametrize("kernel,n_rows,n_deg", CRAFTED_CASES)
def test_mirrored_loop_holds_on_the_crafted_batch(kernel, n_rows, n_deg):
    sc = scene_and_camera("cornell")[0]
    pack, r8 = crafted_dense(sc.tris, n_rows, n_deg)
    sub = ck.sub_boxes(pack, [(0, n_rows)])
    assert sub.shape[0] == -(-n_rows // SUB)
    rays = torch.from_numpy(r8)
    plain = PLAIN[kernel](rays, pack)
    tested = dense_tests(r8, pack, TEST[kernel])
    for coop in (-1, 16, 32):
        got, _ = mirror(kernel, rays, pack, sub.numpy(), coop, tested)
        assert bits_equal(got, plain), coop
    kind = np.arange(r8.shape[1]) % 6
    zero = torch.from_numpy(kind == 3)
    # D = 0: a miss, (BIG, 0), row 0's attributes + 0.0.
    assert (plain[0][zero] == (-1.0 if kernel == "minarg_fused"
                               else k1.BIG)).all()
    if kernel == "mxu":
        assert (plain[1][zero] == 0.0).all()
    assert not (torch.signbit(plain[-4]) & (plain[-4] == 0.0)).any()
    t, ok = k1.mxu_exact_test(pack, rays)
    if n_deg:
        above = ok[0] & (t[0] > k1.BIG)
        assert int(above.sum()) > 10
        if kernel == "mxu" and n_rows > n_deg:
            # The first row that does not accept wins over rows accepted
            # above BIG: index n_deg (or a real hit below it) on those rays.
            assert (plain[1][above] >= n_deg).all()
        if kernel == "mxu" and n_rows == 33:
            # The rays from far above miss sub-block 1's box, which the
            # kernel must not skip: its row 32 wins with BIG.
            far = torch.from_numpy(kind == 2)
            assert (plain[0][far] == k1.BIG).all()
            assert (plain[1][far] == 32.0).all()
            cr = cull_ray(r8[0:3, kind == 2], r8[3:6, kind == 2])
            assert not box_maybe(cr, sub.numpy()[1][:, None],
                                 np.full(int(far.sum()), BIG32)).any()
    if n_rows == 804:
        # Rows 1 and 33 are one triangle: rays that hit it meet an exact-t
        # tie across sub-blocks 0 and 1, and row 1 wins.
        t1, ok1 = k1.exact_test(pack[[1, 33]], rays)
        tie = ok1.all(0) & (t1[0] == t1[1]) & (t1[0] < k1.BIG)
        plain1 = k2.minarg_fused_plain(rays, pack)[0]
        g1 = k1.minarg_plain(rays, pack)[1]
        won = tie & (plain1 == t1[0])
        assert int(won.sum()) > 5 and (g1[won] == 1.0).all()


@pytest.mark.parametrize("name", ["cornell", "reference"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_skipping_changes_no_bit_against_the_first_walk(kernel, name):
    """With a table that skips nothing (the first kernel's walk) the
    mirror gives the same outputs, and more tests reach the divide."""
    _, _, pack, sub = scene_and_camera(name)
    r8 = ray_batch(name, 1)
    tested = dense_tests(r8.numpy(), pack, TEST[kernel])
    a, ca = mirror(kernel, r8, pack, sub.numpy(), 16, tested)
    b, cb = mirror(kernel, r8, pack, never_skipped(sub.shape[0]), -1,
                   tested)
    assert bits_equal(a, b)
    live = int((r8[3:6] != 0.0).any(0).sum())
    assert ca[0] < cb[0] == live * pack.shape[0]


@pytest.mark.parametrize("kernel", KERNELS)
def test_wrapper_takes_the_table(kernel):
    _, _, pack, sub = scene_and_camera("cornell")
    r8 = ray_batch("cornell", 0)
    wrap = {"minarg_fused": k2.minarg_fused, "mxu": k1.mxu}[kernel]
    assert sub.shape == (26, 8)
    assert bits_equal(wrap(r8, pack, sub), PLAIN[kernel](r8, pack))
    with pytest.raises(ValueError, match="sub has shape"):
        wrap(r8, pack, sub[:, :7].contiguous())
    with pytest.raises(ValueError, match="sub has 25 rows"):
        wrap(r8, pack, sub[:-1])
    with pytest.raises(ValueError, match="sub has 27 rows"):
        wrap(r8, pack, torch.cat([sub, sub[:1]]))
    simt = {"minarg_fused": lambda: k2.minarg_fused_simt(r8, pack),
            "mxu": lambda: k1.mxu_simt(r8, pack)}[kernel]
    counted = {"minarg_fused": lambda: k2.minarg_fused_counted(r8, pack, sub),
               "mxu": lambda: k1.mxu_counted(r8, pack, sub)}[kernel]
    for fn in (simt, counted):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fn()


def test_intersectors_build_no_table_on_the_cpu():
    """The injected intersectors on CPU tensors take the plain versions;
    the table is built once per scene on the card only."""
    sc, _, pack, _ = scene_and_camera("cornell")
    r8 = ray_batch("cornell", 0)
    rays = Rays(p=tuple(r8[j] for j in range(3)),
                d=tuple(r8[j] for j in range(3, 6)))
    t14 = k2.make_minarg_intersect(sc.tris, fuse_fetch=True)(rays).t
    assert torch.equal(t14, k2.minarg_fused_plain(r8, pack)[0])
    t15 = k1.make_mxu_intersect(sc.tris)(rays).t
    tp = k1.mxu_plain(r8, pack)[0]
    assert torch.equal(t15, torch.where(tp < k1.BIG, tp,
                                        torch.full_like(tp, -1.0)))


@pytest.mark.parametrize("n_rows,n_deg", ABOVE_BIG_CASES)
def test_minarg_fused_follows_reference_above_big(n_rows, n_deg):
    """A ray whose row 0 accepts it above BIG takes the reference's argmin
    (csrc/argmin_start.cuh), whose rows that do not accept compete with
    BIG: K14's mirror equals the plain version, t and every attribute,
    and such a miss carries the first row that does not accept, row
    n_deg, not K1's old start (BIG, 0)."""
    sc = scene_and_camera("cornell")[0]
    pack, r8 = crafted_dense(sc.tris, n_rows, n_deg)
    sub = ck.sub_boxes(pack, [(0, n_rows)])
    rays = torch.from_numpy(r8)
    plain = k2.minarg_fused_plain(rays, pack)
    for coop in (-1, 16, 32):
        got, _ = mirror("minarg_fused", rays, pack, sub.numpy(), coop)
        assert bits_equal(got, plain), coop
    t, ok = k1.exact_test(pack, rays)
    above = ok[0] & (t[0] > k1.BIG) & ~(ok & (t < k1.BIG)).any(0)
    g = k1.minarg_plain(rays, pack)[1]
    assert int(above.sum()) > 10 and (got[0][above] == -1.0).all()
    assert (g[above] == n_deg).all()
    # Row n_deg's attributes, not row 0's: the start that K1 kept before.
    assert not torch.equal(pack[n_deg, 16], pack[0, 16])
    assert (got[4][above] == pack[n_deg, 16] + 0.0).all()
    assert DEGENERATE_C0 > k1.BIG
