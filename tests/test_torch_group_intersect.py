"""K16 (`accel='group'`) in the port against the JAX package's
`sorted_intersect`: the per-ray slab mask (`_perray_slab`) bit-equal; K16's
plain version bit-equal to interpret-mode `_run_group` on the JAX packs
(carried by interop) with the JAX package's mask sort and unions;
`make_group_intersect`'s Hits bit-equal to JAX's on the cornell rays, the
axis-aligned and on-face rays, and 777 rays
(`tests/test_sorted_intersect.py:42-78`); and the 30-cluster limit
refused with ValueError by both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.ops.pallas import cluster_kernel as jck
from opencl_path_tracer_tpu.ops.pallas import sorted_intersect as jsi
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import interop
from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
from opencl_path_tracer_tpu_torch.scene import library
from test_torch_cluster_kernel import _bits, _both_rays, _random_rays

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)


def _sorted_intersect_rays(r, seed=1, lo=-90.0, hi=990.0):
    """`tests/test_sorted_intersect.py::_rand_rays` as numpy."""
    rs = np.random.default_rng(seed)
    p = rs.uniform(lo, hi, size=(r, 3)).astype(np.float32)
    d = rs.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return p, d


def _on_face_rays():
    """Rays lying on cluster faces with d == 0 components."""
    p = np.array([[-100.0, 500.0, 500.0], [500.0, 1000.0, 500.0],
                  [500.0, 500.0, -0.0], [500.0, 0.0, 500.0]], np.float32)
    d = np.array([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0],
                  [0.0, 1.0, 0.0]], np.float32)
    return p, d


def _assert_hits_bit_equal(jh, ph):
    np.testing.assert_array_equal(_bits(ph.t.numpy()), _bits(jh.t))
    np.testing.assert_array_equal(ph.mati.numpy(), np.asarray(jh.mati))
    for k in range(3):
        np.testing.assert_array_equal(_bits(ph.p[k].numpy()), _bits(jh.p[k]))
        np.testing.assert_array_equal(_bits(ph.n[k].numpy()), _bits(jh.n[k]))


def test_perray_slab_bit_equal():
    js = jck.build_clusters(jlib.cornell_box(with_spheres=True).tris, 128,
                            split_large=True)[0]
    p, d = _random_rays(3000, 7)
    p[:4], d[:4] = _on_face_rays()
    comps = [p[:, k] for k in range(3)] + [d[:, k] for k in range(3)]
    jm = np.asarray(jsi._perray_slab([jnp.asarray(x) for x in comps],
                                     js.boxes))
    boxes = interop.cluster_scene_from_numpy(np.asarray(js.boxes),
                                             np.asarray(js.tri_pack)).boxes
    pm = si._perray_slab([torch.from_numpy(x.copy()) for x in comps], boxes)
    np.testing.assert_array_equal(pm.numpy(), jm)
    assert 0.1 < jm.mean() < 0.9


def test_k16_plain_bit_equal_to_interpret_mode():
    """The JAX intersector's own inputs to `_run_group`: its mask-sorted
    rays and unions, captured from a call on 2,048 cornell rays (block
    512), fed to the port's K16 with the packs carried by interop."""
    scene = jlib.cornell_box(with_spheres=True)
    js, c, k = jck.build_clusters(scene.tris, 128, split_large=True)
    got = {}
    real = jsi._run_group

    def capture(union, rays8, tri_pack, blk, cc, interpret):
        got.update(union=union, rays8=rays8, blk=blk)
        out = real(union, rays8, tri_pack, blk, cc, interpret)
        got["out"] = out
        return out

    jsi._run_group = capture
    try:
        p, d = _sorted_intersect_rays(2048, seed=9)
        jsi.make_group_intersect(scene.tris, block=512, interpret=True)(
            _both_rays(p, d)[0])
    finally:
        jsi._run_group = real
    cs = interop.cluster_scene_from_numpy(np.asarray(js.boxes),
                                          np.asarray(js.tri_pack))
    union = torch.tensor(np.array(got["union"]).astype(np.int32))
    pout = si.run_group(union, torch.tensor(np.array(got["rays8"])),
                        cs.rows(), k, got["blk"])
    for a, b in zip(pout, got["out"]):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    # Unions of the mask-sorted blocks are narrower than all clusters.
    assert int(union.min()) < (1 << c) - 1
    assert float((pout[0] < si.BIG).float().mean()) > 0.5


@pytest.mark.parametrize("case", ["cornell4096", "on_face", "odd777"])
def test_make_group_intersect_bit_equal(case):
    """The three rays of `tests/test_sorted_intersect.py`'s group tests,
    with their tr and subtiles."""
    spheres = case != "on_face"
    jt = jlib.cornell_box(with_spheres=spheres).tris
    pt = library.cornell_box(with_spheres=spheres).tris
    p, d = {"cornell4096": lambda: _sorted_intersect_rays(4096),
            "on_face": _on_face_rays,
            "odd777": lambda: _sorted_intersect_rays(777, seed=3)}[case]()
    sub = {"cornell4096": 2, "on_face": 1, "odd777": 4}[case]
    jr, pr = _both_rays(p, d)
    jh = jsi.make_group_intersect(jt, tr=256, subtiles=sub,
                                  interpret=True)(jr)
    ph = si.make_group_intersect(pt, tr=256, subtiles=sub)(pr)
    _assert_hits_bit_equal(jh, ph)
    assert bool((ph.t > 0).any())


def test_more_than_30_clusters_refused_by_both():
    jt, pt = jlib.stress_scene(1200).tris, library.stress_scene(1200).tris
    with pytest.raises(ValueError, match="u32 mask"):
        jsi.make_group_intersect(jt, cluster_size=16, interpret=True)
    with pytest.raises(ValueError, match="u32 mask"):
        si.make_group_intersect(pt, cluster_size=16)
    si.make_group_intersect(pt, cluster_size=32)        # 24 clusters
    assert jax.devices()[0].platform == "cpu"
