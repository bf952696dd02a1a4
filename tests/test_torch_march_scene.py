"""The stress scene and the pair intersector's cluster build in the port
against the JAX package, on the CPU: `stress_scene` (triangles, spheres,
materials), the Morton codes, `split_by_size` (with its row indices),
`_auto_cluster_size`, and `build_march_scene`'s Morton order and packs
(trig, tric with the eps columns, tab3, the cluster boxes) and
`build_dops`, all bit-equal on stress_scene(1200) (740 triangles) and
stress_scene(6000) (5,780)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.accel.lbvh import morton3 as jmorton3
from opencl_path_tracer_tpu.ops.pallas import sorted_intersect as jsi
from opencl_path_tracer_tpu.ops.pallas.march_kernel import (
    build_march_scene as jbuild,
)
from opencl_path_tracer_tpu.ops.pallas.pair_mxu import build_dops as jdops
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.accel.lbvh import morton3
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.ops.kernels import pair_mxu
from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
from opencl_path_tracer_tpu_torch.ops.kernels.march_kernel import (
    build_march_scene, split_bf16x3,
)
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

CASES = [(1200, 128), (6000, 256)]   # (triangle budget, cluster size)


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


def _scenes(n, **kw):
    return jlib.stress_scene(n, **kw), library.stress_scene(n, **kw)


@pytest.mark.parametrize("n", [1200, 6000])
@pytest.mark.parametrize("analytic", [False, True])
def test_stress_scene_equals_jax(n, analytic):
    js, ps = _scenes(n, analytic=analytic)
    assert ps.num_triangles == int(js.tris.count)
    for f in ("r1", "r2", "r3", "n", "m1", "m2", "m3", "c0", "d1", "d2",
              "d3", "mati"):
        np.testing.assert_array_equal(getattr(ps.tris, f).numpy(),
                                      np.asarray(getattr(js.tris, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(ps.mats.kd[0].numpy(),
                                  np.asarray(js.mats.kd[0]))
    if analytic:
        assert ps.spheres.count == int(js.spheres.count)
        np.testing.assert_array_equal(ps.spheres.rad.numpy(),
                                      np.asarray(js.spheres.rad))
    else:
        assert ps.spheres is None and js.spheres is None


def test_stress_scene_smooth_attribs_equal_jax():
    js, ps = _scenes(1200, smooth=True)
    np.testing.assert_array_equal(ps.attribs.packed.numpy(),
                                  np.asarray(js.attribs.packed))


def test_morton3_equals_jax():
    q = np.random.default_rng(0).uniform(-0.1, 1.1, (50_000, 3))
    q = q.astype(np.float32)
    q[:4] = [[1.0, 0.0, 0.99999994], [0.5, 0.25, 0.125], [0.0, 0.0, 0.0],
             [1.0, 1.0, 1.0]]
    np.testing.assert_array_equal(morton3(q),
                                  np.asarray(jmorton3(jnp.asarray(q))))


@pytest.mark.parametrize("n,cs", CASES)
def test_split_and_cluster_size_equal_jax(n, cs):
    js, ps = _scenes(n)
    jb, jr, jbi, jri = jsi.split_by_size(js.tris, with_indices=True)
    pb, pr, pbi, pri = si.split_by_size(ps.tris, with_indices=True)
    np.testing.assert_array_equal(pbi, jbi)
    np.testing.assert_array_equal(pri, jri)
    assert pb.count == 18 and pb.count + pr.count == ps.num_triangles
    for part_p, part_j in ((pb, jb), (pr, jr)):
        for f in ("r1", "n", "m2", "c0", "d1", "mati"):
            np.testing.assert_array_equal(getattr(part_p, f).numpy(),
                                          np.asarray(getattr(part_j, f)))
    for count in (pr.count, 99_362, 2_000_000, 40_000_000):
        assert si._auto_cluster_size(count, cs) == \
            jsi._auto_cluster_size(count, cs)


@pytest.mark.parametrize("n,cs", CASES)
def test_march_scene_packs_bit_equal(n, cs):
    js, ps = _scenes(n)
    _, jrest = jsi.split_by_size(js.tris)
    _, prest = si.split_by_size(ps.tris)
    jm, jrt, jc, jorder = jbuild(jrest, cs, with_order=True)
    pm, prt, pc, porder = build_march_scene(prest, cs, with_order=True)
    assert pc == jc == -(-prest.count // cs)
    np.testing.assert_array_equal(porder, np.asarray(jorder))
    for f in ("r1", "r3", "n", "m1", "d3", "mati"):
        np.testing.assert_array_equal(getattr(prt, f).numpy(),
                                      np.asarray(getattr(jrt, f)))
    for f in ("trig", "tric", "boxes_lo", "boxes_hi"):
        np.testing.assert_array_equal(_bits(getattr(pm, f)),
                                      _bits(getattr(jm, f)), err_msg=f)
    np.testing.assert_array_equal(_bits(split_bf16x3(pm.tric)),
                                  _bits(jm.tab3))
    np.testing.assert_array_equal(pair_mxu.build_dops(prt, cs, pc).numpy(),
                                  np.asarray(jdops(jrt, cs, jc)))
    # tric's first 17 columns are the padded triangle pack.
    pack = k1.build_tri_pack(prt, cs)
    np.testing.assert_array_equal(pm.tric[:pack.shape[0], :17].numpy(),
                                  pack[:, :17].numpy())


@pytest.mark.parametrize("count,tt,rows", [(5, 512, 8), (512, 512, 512),
                                           (513, 512, 1024), (740, 128, 768)])
def test_build_tri_pack_padding_rule(count, tt, rows):
    """JAX's rule: a multiple of 8 up to tt triangles, else of tt; zero
    rows never hit."""
    ps = library.stress_scene(1200)
    tris = ps.tris.take(np.arange(count))
    pack = k1.build_tri_pack(tris, tt)
    assert pack.shape == (rows, 24)
    assert torch.equal(pack[:count], k1.build_tri_pack(tris))
    assert not pack[count:].any()
