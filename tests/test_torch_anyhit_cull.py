"""K7 with the sub-block skip rule (csrc/anyhit.cu), on the CPU, and the
megakernel's NEE schedule, which traces no shadow ray on the last bounce.

Inside a group it needs, the kernel skips, per ray, each sub-block of SUB
rows whose box the segment P + s D, 0 <= s <= rmax, misses. A mirror of
that loop (tests/sub_cull_mirror.py) must give `anyhit_plain`'s flags on
the NEE shadow rays of bounces 0, 1 and 2 of the Cornell box and of the
reference scene (whose Wineglass has zero-area triangles, which the
group culling never reaches outside their group's box), with rmax also
0, negative, NaN, infinite and subnormal. The table follows the groups,
and the rows of zero-area triangles lie in sub-blocks that are never
skipped.
"""

import pathlib

import numpy as np
import pytest
import torch

from sub_cull_mirror import SUB, mirrored_anyhit
from opencl_path_tracer_tpu_torch.models import megakernel
from opencl_path_tracer_tpu_torch.ops import nee, raygen, rng
from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.ops.kernels import tilecull_kernel as tk
from opencl_path_tracer_tpu_torch.runtime.cull_ab import _bounce, shadow_rays
from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

MODELS = str(pathlib.Path(__file__).resolve().parent / "assets" / "models")
W, H = 32, 24
_CACHE = {}


def scene_and_camera(name):
    if name not in _CACHE:
        if name == "cornell":
            sc = library.cornell_box(with_spheres=True)
            cam = library.cornell_camera(W, H)
        else:
            sc = library.reference_scene(MODELS, smooth=True)
            cam = library.reference_camera(W, H)
        pack, groups, _ = tk.grouped_pack(sc.tris, 128)
        _CACHE[name] = (sc, cam, pack, groups,
                        tk.anyhit_sub_boxes(pack, groups))
    return _CACHE[name]


def shadow_batch(name, bounce):
    """(s8 (8, R) float32, rmax (R,) float32): NEE's shadow rays at the
    hits of the camera rays' `bounce`-th bounce."""
    sc, cam, *_ = scene_and_camera(name)
    s1, u1 = rng.lehmer_step(rng.seed_pixel_streams(W * H, 1))
    _, u2 = rng.lehmer_step(s1)
    rays = raygen.camera_rays(cam, raygen.pixel_ids(W, H, "cpu"), u1, u2)
    for _ in range(bounce):
        rays = _bounce(sc, cam, rays)
    shadow, rmax = shadow_rays(sc, cam, rays, make_intersect_fn(sc, "auto"))
    return k1.pack_rays(shadow.p, shadow.d).contiguous(), rmax


@pytest.mark.parametrize("bounce", [0, 1, 2])
@pytest.mark.parametrize("name", ["cornell", "reference"])
def test_mirrored_loop_equals_anyhit_plain(name, bounce):
    _, _, pack, groups, sub = scene_and_camera(name)
    s8, rmax = shadow_batch(name, bounce)
    rmax = rmax.clone()
    # Special segment lengths on every seventh ray.
    special = torch.tensor([0.0, -0.0, -5.0, float("nan"), float("inf"),
                            1e-42, 3.0e38])
    rmax[::7] = special.repeat(-(-rmax[::7].shape[0] // 7))[
        :rmax[::7].shape[0]]
    plain = tk.anyhit_plain(s8, rmax, pack, groups).numpy()
    occ, n_div, n_box = mirrored_anyhit(s8.numpy(), rmax.numpy(), pack,
                                        groups.numpy(), sub.numpy())
    assert np.array_equal(occ, plain)
    assert 10 < plain.sum() < plain.shape[0]
    for j in range(4):                      # rmax 0, -0, -5, NaN
        assert not plain[7 * j::49].any()
    # The rule is not vacuous: under half of the rows of the needed
    # groups reach the divide.
    first = sum(int(e - b) for b, e in groups[:, 6:8].long().tolist())
    assert n_div < 0.5 * first * s8.shape[1]


@pytest.mark.parametrize("name", ["cornell", "reference"])
def test_table_follows_the_groups(name):
    """K7's table: each group's sub-blocks from its base (the last group's
    partial), none taking a row of the next group."""
    _, _, pack, groups, sub = scene_and_camera(name)
    spans = groups[:, 6:8].long().tolist()
    assert spans[0][0] == 0 and all(
        a[1] == b[0] for a, b in zip(spans, spans[1:]))
    parts = [ck.sub_boxes(pack[b:e], [(0, e - b)]).numpy() for b, e in spans]
    assert np.array_equal(sub.numpy(), np.concatenate(parts))
    assert sub.shape[0] == sum(-(-(e - b) // SUB) for b, e in spans)


def test_zero_area_rows_are_never_skipped():
    sc, _, pack, groups, sub = scene_and_camera("reference")
    _, perm, _, spans = tk.build_groups(sc.tris, 128)
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


def test_wrappers_take_the_table():
    _, _, pack, groups, sub = scene_and_camera("cornell")
    s8, rmax = shadow_batch("cornell", 0)
    assert sub.shape == (sum(-(-(e - b) // SUB) for b, e in
                             groups[:, 6:8].long().tolist()), 8)
    assert torch.equal(tk.anyhit(s8, rmax, pack, groups, sub),
                       tk.anyhit(s8, rmax, pack, groups))
    with pytest.raises(ValueError, match="sub has shape"):
        tk.anyhit(s8, rmax, pack, groups, sub[:, :7].contiguous())
    for fn in (lambda: tk.anyhit_simt(s8, rmax, pack, groups),
               lambda: tk.anyhit_counted(s8, rmax, pack, groups, sub)):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fn()


def test_megakernel_traces_no_shadow_ray_on_the_last_bounce(monkeypatch):
    """The last bounce's NEE contribution is masked to zero: the render is
    the same bits whether its shadow rays are traced or not, the shadow
    batch counts in rays_traced either way, and the any-hit test runs on
    every bounce but the last."""
    sc = library.cornell_box(with_spheres=True)
    cam = library.cornell_camera(16, 16)
    table = nee.build_emitter_table(sc.tris, sc.mats, sc.spheres)
    occ = tk.make_scene_occluded(sc)
    isect = make_intersect_fn(sc, "auto")
    calls = []

    def counted(rays, rmax):
        calls.append(rmax.shape[0])
        return occ(rays, rmax)

    def render():
        calls.clear()
        st = megakernel.init_state(256, 1)
        st, traced = megakernel.trace_sample(
            cam, sc.mats, st, intersect_fn=isect, iterations=4, mode="fast",
            key=rng.key(3), nee=table, occluded_fn=counted, with_stats=True)
        return megakernel.colors_array(st), float(traced), len(calls)

    colors, traced, n = render()
    assert n == 3
    monkeypatch.setattr(megakernel, "_unoccluded", counted)
    colors_all, traced_all, n_all = render()
    assert n_all == 4
    assert torch.equal(colors, colors_all) and traced == traced_all
    assert float(colors.mean()) > 0.0
