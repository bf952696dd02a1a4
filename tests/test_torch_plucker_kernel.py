"""K2 (refine1) and the minarg intersector in the port against the JAX
package's `make_minarg_intersect` run in interpret mode: t, normal
(bit pattern, sign of zero included), material and winner ids must be
bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.core.types import Rays as JRays
from opencl_path_tracer_tpu.ops.pallas.plucker_kernel import (
    make_minarg_intersect as jmake,
)
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.core.types import Rays
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.ops.kernels import plucker_kernel as k2
from opencl_path_tracer_tpu_torch.scene import library as plib

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _box_rays(n, seed):
    rs = np.random.default_rng(seed)
    p = np.stack([rs.uniform(-100, 1100, n), rs.uniform(0, 1000, n),
                  rs.uniform(-1000, 1000, n)], 1).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:20] = np.float32([0.0, 0.0, 1.0])     # axis-aligned: signed zeros
    p[-20:] = np.float32([500.0, 500.0, -5000.0])
    d[-20:] = np.float32([0.0, 0.0, -1.0])   # heading out: misses
    return (JRays(p=tuple(jnp.asarray(p[:, k]) for k in range(3)),
                  d=tuple(jnp.asarray(d[:, k]) for k in range(3))),
            Rays(p=tuple(torch.from_numpy(p[:, k].copy()) for k in range(3)),
                 d=tuple(torch.from_numpy(d[:, k].copy())
                         for k in range(3))))


@pytest.mark.parametrize("spheres", [False, True])
def test_minarg_intersect_bit_equal(spheres):
    js = jlib.cornell_box(with_spheres=spheres)
    ps = plib.cornell_box(with_spheres=spheres)
    jr, pr = _box_rays(600, int(spheres))
    jh, jids = jmake(js.tris, with_ids=True, interpret=True)(jr)
    ph, pids = k2.make_minarg_intersect(ps.tris, with_ids=True)(pr)
    np.testing.assert_array_equal(_bits(ph.t.numpy()), _bits(jh.t))
    np.testing.assert_array_equal(ph.mati.numpy(), np.asarray(jh.mati))
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    for k in range(3):
        np.testing.assert_array_equal(_bits(ph.n[k].numpy()), _bits(jh.n[k]))
        np.testing.assert_array_equal(_bits(ph.p[k].numpy()), _bits(jh.p[k]))
    assert (ph.t.numpy()[-20:] == -1.0).all()
    assert (pids.numpy()[-20:] == -1).all()


def test_refine1_plain_semantics():
    ps = plib.cornell_box(with_spheres=False)
    pack = k1.build_tri_pack(ps.tris)
    t1 = torch.tensor([5.0, k1.BIG, 2.0])
    g1 = torch.tensor([3.0, 0.0, 11.0])
    t, nx, ny, nz, m = k2.refine1(t1, g1, pack)
    assert t.tolist() == [5.0, -1.0, 2.0]
    assert m.tolist() == [float(ps.tris.mati[i]) for i in (3, 0, 11)]
    # The TPU fetch is a one-hot sum: -0.0 comes back as +0.0.
    for c in (nx, ny, nz):
        assert not torch.signbit(c[c == 0.0]).any()
    with pytest.raises(ValueError):
        k2.refine1(t1, g1[:2], pack)
