"""The 'bvh' and 'median' accels in the port against the JAX package:
`finalize_bvh`, `build_median_tree` (both splits, a single triangle,
midpoints identical on every axis, the per-object forest over the
reference scene's object_ranges) and `build_lbvh` bit-equal (nodes,
triangle pack, normals, material ids, depth, leaf size); the walker
`make_bvh_intersect` on both kinds of tree, on random rays and on 16x16
Cornell camera rays, t, p, n and mati bit-equal to JAX's walker (its
`lax.while_loop` body is compiled by XLA, whose CPU dot order the
port's `_dot3` repeats: accel/traverse.py); 16x16 Cornell renders with
accel 'bvh' and 'median' against the JAX engine's at the goldens' rtol
1e-4; and the CUDA gate (`force`)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from opencl_path_tracer_tpu.accel import (
    build_lbvh as jlbvh, build_median_tree as jmedian,
    make_bvh_intersect as jwalker,
)
from opencl_path_tracer_tpu.accel.types import finalize_bvh as jfinalize
from opencl_path_tracer_tpu.core.geometry import TrianglesSoA as JTris
from opencl_path_tracer_tpu.core.types import Rays as JRays
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.accel import (
    build_lbvh, build_median_tree, make_bvh_intersect,
)
from opencl_path_tracer_tpu_torch.accel.types import finalize_bvh
from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.types import Rays
from opencl_path_tracer_tpu_torch.ops import raygen, rng
from opencl_path_tracer_tpu_torch.runtime import engine
from opencl_path_tracer_tpu_torch.scene import library
from test_torch_cluster_render import render_both

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

MODELS = "tests/assets/models"


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _tris(v, m=None):
    m = np.arange(v.shape[0], dtype=np.int32) % 7 if m is None else m
    return (JTris.build(v[:, 0], v[:, 1], v[:, 2], m),
            TrianglesSoA.build(v[:, 0], v[:, 1], v[:, 2], m))


def _random_tris(t, seed):
    rs = np.random.default_rng(seed)
    centers = rs.uniform(-10, 10, size=(t, 1, 3))
    return (centers + rs.normal(size=(t, 3, 3)) * 0.6).astype(np.float32)


def _assert_bvh_equal(jb, pb):
    for f in ("nodes", "tri_pack", "tri_n"):
        np.testing.assert_array_equal(_bits(getattr(pb, f).numpy()),
                                      _bits(getattr(jb, f)))
    np.testing.assert_array_equal(pb.tri_mati.numpy(), np.asarray(jb.tri_mati))
    assert (pb.depth, pb.leaf_size) == (jb.depth, jb.leaf_size)


def test_finalize_bvh_bit_equal():
    jt, pt = _tris(_random_tris(10, 1))
    nodes = np.arange(16, dtype=np.float32).reshape(2, 8)
    order = np.array([3, 1, 0, 0, 9, 2, 0, 0])
    pad = np.array([0, 0, 1, 1, 0, 0, 1, 1], bool)
    _assert_bvh_equal(jfinalize(nodes, order, pad, jt, 3, 4),
                      finalize_bvh(nodes, order, pad, pt, 3, 4))


def _identical_midpoints():
    """Triangles whose midpoints coincide on every axis (rotations of one
    triangle about its centroid): the reference's builder loops forever,
    the port halves the index list as JAX's does."""
    base = np.array([[1, 0, 0], [-0.5, 0.8, 0], [-0.5, -0.8, 0]], np.float32)
    v = np.stack([np.roll(base, k % 3, axis=0) * (1 + k) for k in range(9)])
    return v + np.float32(5.0)


@pytest.mark.parametrize("case", ["random", "single", "identical"])
@pytest.mark.parametrize("split", ["median", "midpoint_mean"])
def test_median_tree_bit_equal(case, split):
    v = {"random": lambda: _random_tris(300, 2),
         "single": lambda: _random_tris(1, 3),
         "identical": _identical_midpoints}[case]()
    jt, pt = _tris(v)
    _assert_bvh_equal(jmedian(jt, split=split), build_median_tree(pt,
                                                                  split=split))


def test_median_tree_per_object_forest_bit_equal():
    """The reference scene's per-object forest (split='midpoint_mean')."""
    js = jlib.reference_scene(models_dir=MODELS)
    ps = library.reference_scene(models_dir=MODELS)
    np.testing.assert_array_equal(ps.object_ranges, js.object_ranges)
    assert len(ps.object_ranges) > 1
    _assert_bvh_equal(
        jmedian(js.tris, split="midpoint_mean",
                object_ranges=js.object_ranges),
        build_median_tree(ps.tris, split="midpoint_mean",
                          object_ranges=ps.object_ranges))


@pytest.mark.parametrize("t,leaf", [(300, 4), (804, 4), (37, 2)])
def test_lbvh_bit_equal(t, leaf):
    if t == 804:
        jt, pt = (jlib.cornell_box(with_spheres=True).tris,
                  library.cornell_box(with_spheres=True).tris)
    else:
        jt, pt = _tris(_random_tris(t, 4))
    _assert_bvh_equal(jlbvh(jt, leaf_size=leaf), build_lbvh(pt,
                                                            leaf_size=leaf))


def _random_rays(n, seed, lo, hi):
    rs = np.random.default_rng(seed)
    p = rs.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    return p, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _camera_rays():
    cam = library.cornell_camera(16, 16)
    s1, r1 = rng.lehmer_step(rng.seed_pixel_streams(256, 1))
    _, r2 = rng.lehmer_step(s1)
    rays = raygen.camera_rays(cam, raygen.pixel_ids(16, 16, "cpu"), r1, r2)
    return (np.stack([x.numpy() for x in rays.p], 1),
            np.stack([x.numpy() for x in rays.d], 1))


@pytest.mark.parametrize("tree", ["lbvh", "median", "midpoint_mean"])
@pytest.mark.parametrize("scene", ["random", "cornell"])
def test_walker_bit_equal(tree, scene):
    if scene == "random":
        jt, pt = _tris(_random_tris(500, 4))
        p, d = _random_rays(1500, 5, -12.0, 12.0)
    else:
        jt, pt = (jlib.cornell_box(with_spheres=True).tris,
                  library.cornell_box(with_spheres=True).tris)
        p, d = _camera_rays()
        # Axis-parallel directions: the slab test's 0 * inf = NaN.
        d[:8] = 0.0
        d[np.arange(8), np.arange(8) % 3] = 1.0
    if tree == "lbvh":
        jb, pb = jlbvh(jt), build_lbvh(pt)
    else:
        jb, pb = jmedian(jt, split=tree), build_median_tree(pt, split=tree)
    jh = jwalker(jb)(JRays.make(jnp.asarray(p), jnp.asarray(d)))
    walk = make_bvh_intersect(pb)
    ph = walk(Rays(p=tuple(torch.from_numpy(p[:, k].copy()) for k in range(3)),
                   d=tuple(torch.from_numpy(d[:, k].copy())
                           for k in range(3))))
    np.testing.assert_array_equal(_bits(ph.t.numpy()), _bits(jh.t))
    np.testing.assert_array_equal(ph.mati.numpy(), np.asarray(jh.mati))
    for k in range(3):
        np.testing.assert_array_equal(_bits(ph.p[k].numpy()), _bits(jh.p[k]))
        np.testing.assert_array_equal(_bits(ph.n[k].numpy()), _bits(jh.n[k]))
    hit = ph.t.numpy() > 0
    assert hit.mean() > (0.05 if scene == "random" else 0.9)
    assert walk.iterations > 2 * pb.depth and walk.steps >= walk.iterations


@pytest.mark.parametrize("accel", ["bvh", "median"])
def test_engine_render_matches_jax(accel):
    jimg, pimg = render_both(jlib.cornell_box(with_spheres=True),
                             library.cornell_box(with_spheres=True), accel,
                             "megakernel")
    np.testing.assert_allclose(pimg, jimg, rtol=1e-4, atol=1e-6)
    assert pimg.mean() > 0.0


def test_cuda_gate_and_ids_refusal():
    """On CUDA the walkers need force (the message gives the card's
    reason); the CPU runs them; smooth shading refuses all three new
    accels, which report no ids."""
    for accel in ("bvh", "median"):
        with pytest.raises(ValueError, match="no hand-written kernel"):
            engine.resolve_accel(accel, 804, on_cuda=True)
        assert engine.resolve_accel(accel, 804, on_cuda=True,
                                    force=True) == accel
    ps = library.cornell_box(with_spheres=True, smooth_spheres=True)
    for accel in ("bvh", "median", "pairmx"):
        with pytest.raises(ValueError, match="ids-reporting"):
            engine.make_intersect_fn(ps, accel, smooth=True)
    fn = engine.make_intersect_fn(library.cornell_box(), "median")
    assert fn.accel == "median"
