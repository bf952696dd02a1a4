"""K3 (analytic spheres) in the port against the JAX package's baked
sphere kernel run in interpret mode. t and mati are bit-equal, ties
(two identical spheres) keep the lower index, and misses carry t = -1
and zeros.

The normal's x component is held to atol 2e-6 (an error in t of one
ulp moves it by about 2e-7): XLA's CPU backend recomputes the whole
intersection inside each output's fused loop and contracts
multiply-adds differently in the loop of the x component, so that
loop's t can differ by an ulp from the t it outputs. No single
elementwise form reproduces it; y and z match fma(d, t, p) - c exactly,
and the port rounds all three components that way."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.core.spheres import SpheresSoA as JSph
from opencl_path_tracer_tpu.core.types import Rays as JRays
from opencl_path_tracer_tpu.ops import intersect as jisect
from opencl_path_tracer_tpu.ops.pallas.sphere_kernel import (
    make_sphere_intersect as jmake,
)
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.core.spheres import SpheresSoA
from opencl_path_tracer_tpu_torch.core.types import Rays
from opencl_path_tracer_tpu_torch.ops import intersect
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.ops.kernels import sphere_kernel as k3
from opencl_path_tracer_tpu_torch.scene import library as plib

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _rays(n, seed):
    rs = np.random.default_rng(seed)
    p = np.stack([rs.uniform(-100, 1100, n), rs.uniform(0, 1000, n),
                  rs.uniform(-1000, 1000, n)], 1).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # Aim a third of the rays at the sphere centers.
    c = np.float32([[250.0, 180.0, 500.0], [720.0, 160.0, 350.0]])
    aim = c[np.arange(n // 3) % 2] - p[:n // 3]
    d[:n // 3] = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    return (JRays(p=tuple(jnp.asarray(p[:, k]) for k in range(3)),
                  d=tuple(jnp.asarray(d[:, k]) for k in range(3))),
            Rays(p=tuple(torch.from_numpy(p[:, k].copy()) for k in range(3)),
                 d=tuple(torch.from_numpy(d[:, k].copy())
                         for k in range(3))))


def _compare(jh, ph):
    np.testing.assert_array_equal(_bits(ph.t.numpy()), _bits(jh.t))
    np.testing.assert_array_equal(ph.mati.numpy(), np.asarray(jh.mati))
    for k in (1, 2):
        np.testing.assert_array_equal(_bits(ph.n[k].numpy()), _bits(jh.n[k]))
    np.testing.assert_allclose(ph.n[0].numpy(), np.asarray(jh.n[0]),
                               rtol=0, atol=2e-6)
    miss = ph.t.numpy() < 0
    assert miss.any() and (~miss).any()
    assert (ph.mati.numpy()[miss] == 0).all()
    for k in range(3):
        assert (ph.n[k].numpy()[miss] == 0).all()


def test_spheres_cornell_analytic():
    js = jlib.cornell_box(with_spheres=True, analytic_spheres=True)
    ps = plib.cornell_box(with_spheres=True, analytic_spheres=True)
    jr, pr = _rays(900, 0)
    _compare(jmake(js.spheres, interpret=True)(jr),
             k3.make_sphere_intersect(ps.spheres)(pr))


def test_spheres_ties_keep_lower_index():
    c = [(250.0, 180.0, 500.0), (250.0, 180.0, 500.0), (720.0, 160.0, 350.0)]
    r, m = [180.0, 180.0, 160.0], [7, 9, 8]
    jr, pr = _rays(600, 1)
    jh = jmake(JSph.build(c, r, m), interpret=True)(jr)
    ph = k3.make_sphere_intersect(SpheresSoA.build(c, r, m))(pr)
    _compare(jh, ph)
    assert (ph.mati.numpy() != 9).all()        # the copy never wins


def test_plain_sphere_intersect_near_xla_form():
    """The port's `sphere_intersect` is K3's plain version; the JAX
    package's XLA form sums its dot products in a matmul, so t agrees to
    float32 rounding, as its own kernel test allows (rtol 1e-5)."""
    js = jlib.cornell_box(with_spheres=True, analytic_spheres=True)
    ps = plib.cornell_box(with_spheres=True, analytic_spheres=True)
    jr, pr = _rays(600, 2)
    jh = jisect.sphere_intersect(jr, js.spheres)
    ph = intersect.sphere_intersect(pr, ps.spheres)
    va, vb = np.asarray(jh.valid), ph.valid.numpy()
    np.testing.assert_array_equal(vb, va)
    np.testing.assert_allclose(ph.t.numpy()[va], np.asarray(jh.t)[va],
                               rtol=1e-5)
    np.testing.assert_array_equal(ph.mati.numpy(), np.asarray(jh.mati))


def test_sphere_count_limit():
    """K3 takes at most 64 spheres; make_sphere_intersect sends more to
    K3b (tests/test_torch_sphere_table.py)."""
    ps = plib.cornell_box(with_spheres=True, analytic_spheres=True)
    table = k3.build_sphere_table(ps.spheres)
    with pytest.raises(ValueError, match="K3b"):
        k3.spheres(torch.zeros((8, 4)), table.repeat(33, 1))
    rays8 = k1.pack_rays((torch.zeros(3),) * 3, (torch.ones(3),) * 3)
    assert k3.spheres(rays8, table)[0].shape == (3,)
