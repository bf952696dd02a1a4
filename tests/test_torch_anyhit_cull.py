"""K7 with the sub-block skip rule (csrc/anyhit.cu), on the CPU, and the
megakernel's NEE schedule, which traces no shadow ray on the last bounce.
K7 is also the environment map's escape test, at rmax = 3.0e38 (= BIG):
there every group's entry tn <= rmax passes, the rule culls by the boxes
alone, and the flag must be the nearest hit's (t valid and t < 3.0e38),
also for hits with t far above any scene distance (rays with tiny
directions), as the JAX package's interpret-mode K7 decides.

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
from opencl_path_tracer_tpu_torch.core.types import Rays
from opencl_path_tracer_tpu_torch.models import megakernel
from opencl_path_tracer_tpu_torch.ops import envmap, nee, raygen, rng
from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.ops.kernels import tilecull_kernel as tk
from opencl_path_tracer_tpu_torch.runtime.cull_ab import (
    _bounce, escape_rays, shadow_rays,
)
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


def escape_batch(name, bounce, scale=None):
    """(s8, rmax = 3.0e38): the sun-sky map's escape rays at the hits of
    the camera rays' `bounce`-th bounce. scale: directions multiplied by
    these factors in turn (tiny directions put the hits near or past
    3.0e38)."""
    sc, cam, *_ = scene_and_camera(name)
    s1, u1 = rng.lehmer_step(rng.seed_pixel_streams(W * H, 1))
    _, u2 = rng.lehmer_step(s1)
    rays = raygen.camera_rays(cam, raygen.pixel_ids(W, H, "cpu"), u1, u2)
    for _ in range(bounce):
        rays = _bounce(sc, cam, rays)
    esc, rmax = escape_rays(sc, cam, rays, make_intersect_fn(sc, "auto"),
                            envmap.load_envmap("sunsky"))
    assert bool((rmax == envmap.ESCAPE_RMAX).all())
    s8 = k1.pack_rays(esc.p, esc.d).contiguous()
    if scale is not None:
        f = torch.tensor(scale, dtype=torch.float32).repeat(
            -(-s8.shape[1] // len(scale)))[:s8.shape[1]]
        d = s8[3:6] * f
        # Components the scale leaves subnormal become 0: XLA's CPU reads
        # subnormals as zero and PyTorch does not (ROADMAP.md queue 3).
        s8[3:6] = torch.where(d.abs() < np.finfo(np.float32).tiny,
                              torch.zeros_like(d), d)
    return s8, rmax


@pytest.mark.parametrize("bounce", [0, 1])
@pytest.mark.parametrize("name", ["cornell", "reference"])
def test_escape_rays_at_unbounded_rmax(name, bounce):
    """The mirror equals anyhit_plain on the escape rays, and both equal
    (K4's t valid and t < 3.0e38), but where a zero-area triangle's strip
    outside its group's box would occlude (the reference's Wineglass)."""
    sc, _, pack, groups, sub = scene_and_camera(name)
    s8, rmax = escape_batch(name, bounce)
    plain = tk.anyhit_plain(s8, rmax, pack, groups)
    occ, _, _ = mirrored_anyhit(s8.numpy(), rmax.numpy(), pack,
                                groups.numpy(), sub.numpy())
    assert np.array_equal(occ, plain.numpy())
    t4 = k1.dense_plain(s8, pack)[0]
    nearest = (t4 < k1.BIG) & (t4 < rmax)
    diff = plain != nearest
    assert int(diff.sum()) <= (0 if name == "cornell" else 8)
    assert not bool(plain[diff].any())
    # Both kinds of ray: the box is closed on five sides.
    assert 0 < int(plain.sum()) < plain.shape[0]


@pytest.mark.parametrize("scale", [(1.0, 1e-35, 3e-36, 2e-36),
                                   (1.0, 4e-36, 1e-36, 5e-37)])
def test_anyhit_at_rmax_big_equals_jax_interpret(scale):
    """K7's plain version and the mirror against the JAX package's
    interpret-mode K7 on the cornell escape rays with directions scaled
    so that the hits lie below, near and above 3.0e38 (and overflow to
    inf)."""
    from opencl_path_tracer_tpu.core.types import Rays as JRays
    from opencl_path_tracer_tpu.ops.pallas.tilecull_kernel import (
        make_anyhit_occluded as jocc,
    )
    from opencl_path_tracer_tpu.scene import library as jlib
    import jax.numpy as jnp
    _, _, pack, groups, sub = scene_and_camera("cornell")
    s8, rmax = escape_batch("cornell", 0, scale)
    plain = tk.anyhit_plain(s8, rmax, pack, groups)
    occ, _, _ = mirrored_anyhit(s8.numpy(), rmax.numpy(), pack,
                                groups.numpy(), sub.numpy())
    assert np.array_equal(occ, plain.numpy())
    js = jlib.cornell_box(with_spheres=True)
    p = tuple(jnp.asarray(s8[k].numpy()) for k in range(3))
    d = tuple(jnp.asarray(s8[3 + k].numpy()) for k in range(3))
    ref = np.asarray(jocc(js.tris, interpret=True)(JRays(p=p, d=d),
                                                    jnp.asarray(rmax)))
    np.testing.assert_array_equal(plain.numpy(), ref)
    # Hits far above any scene distance occlude; rays whose unscaled
    # twin hits but whose hit now lies at or past 3.0e38 (or overflows)
    # do not.
    t4 = k1.dense_plain(s8, pack)[0]
    far = (t4 > 1e35) & (t4 < k1.BIG)
    assert int(far.sum()) > 50 and bool(plain[far].all())
    hit1 = k1.dense_plain(escape_batch("cornell", 0)[0], pack)[0] < k1.BIG
    gone = hit1 & (t4 >= k1.BIG)
    assert int(gone.sum()) > 50 and not bool(plain[gone].any())


@pytest.mark.cuda
def test_anyhit_at_unbounded_rmax_equals_plain_on_the_card():
    """K7 on CUDA tensors against its plain version on the escape rays of
    cornell and reference (bounces 0 and 1) and on the scaled batches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    for name, bounce, scale in (("cornell", 0, None), ("cornell", 1, None),
                                ("reference", 0, None),
                                ("reference", 1, None),
                                ("cornell", 0, (1.0, 1e-35, 3e-36, 2e-36))):
        _, _, pack, groups, _ = scene_and_camera(name)
        s8, rmax = escape_batch(name, bounce, scale)
        g_pack, g_groups = pack.to(dev), groups.to(dev)
        g_sub = tk.anyhit_sub_boxes(g_pack, g_groups)
        got = tk.anyhit(s8.to(dev), rmax.to(dev), g_pack, g_groups, g_sub)
        assert torch.equal(got.cpu(), tk.anyhit_plain(s8, rmax, pack,
                                                      groups)), (name, bounce)
