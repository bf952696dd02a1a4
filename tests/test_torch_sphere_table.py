"""K3b (the sphere-table kernel, more than 64 spheres) in the port against
the JAX package's `make_sphere_table_intersect` run in interpret mode:
t, all three normal components and mati are bit-equal (interpret-mode
XLA contracts K3b's dot products, disc and p + t d into the FMAs that
the port's plain version and CUDA kernel use; a probe found no other
pattern), ties keep the lower index, misses carry t = -1 and zeros, and
`make_sphere_intersect` sends more than 64 spheres to K3b as JAX does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.core.spheres import SpheresSoA as JSph
from opencl_path_tracer_tpu.core.types import Rays as JRays
from opencl_path_tracer_tpu.ops.pallas.sphere_kernel import (
    make_sphere_intersect as jmake,
    make_sphere_table_intersect as jmake_table,
)
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.core.spheres import SpheresSoA
from opencl_path_tracer_tpu_torch.core.types import Rays
from opencl_path_tracer_tpu_torch.ops.kernels import sphere_kernel as k3
from opencl_path_tracer_tpu_torch.scene import library as plib

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _rays(centers, n, seed):
    """Rays from inside the box, two thirds aimed near a sphere centre."""
    rs = np.random.default_rng(seed)
    p = np.stack([rs.uniform(-100, 1100, n), rs.uniform(0, 1000, n),
                  rs.uniform(-1000, 1000, n)], 1).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    k = 2 * n // 3
    aim = (centers[rs.integers(0, centers.shape[0], k)]
           + rs.normal(size=(k, 3)).astype(np.float32) * 15.0 - p[:k])
    d[:k] = aim
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (JRays(p=tuple(jnp.asarray(p[:, k]) for k in range(3)),
                  d=tuple(jnp.asarray(d[:, k]) for k in range(3))),
            Rays(p=tuple(torch.from_numpy(p[:, k].copy()) for k in range(3)),
                 d=tuple(torch.from_numpy(d[:, k].copy())
                         for k in range(3))))


def _centers(sph):
    return np.stack([np.asarray(c, np.float32) for c in sph.c], 1)


def _assert_bit_equal(jh, ph):
    np.testing.assert_array_equal(_bits(ph.t.numpy()), _bits(jh.t))
    np.testing.assert_array_equal(ph.mati.numpy(), np.asarray(jh.mati))
    for k in range(3):
        np.testing.assert_array_equal(_bits(ph.n[k].numpy()), _bits(jh.n[k]))
        np.testing.assert_array_equal(_bits(ph.p[k].numpy()), _bits(jh.p[k]))
    miss = ph.t.numpy() < 0
    assert miss.any() and (~miss).any()
    assert (ph.mati.numpy()[miss] == 0).all()


@pytest.mark.parametrize("count", [64, 80])
def test_sphere_table_matches_interpret_mode(count):
    """The many-light scene (66 and 82 spheres) through K3b's plain
    version, against interpret-mode K3b: bit-equal."""
    js = jlib.many_light_scene(count)
    ps = plib.many_light_scene(count)
    jr, pr = _rays(_centers(js.spheres), 600, count)
    jh = jmake_table(js.spheres, interpret=True)(jr)
    ph = k3.make_sphere_table_intersect(ps.spheres)(pr)
    _assert_bit_equal(jh, ph)
    assert int((ph.mati.numpy() >= 10).sum()) > 50     # lamps are hit


def test_make_sphere_intersect_dispatches_above_64(monkeypatch):
    """Above 64 spheres both packages take the table kernel (the port's
    hits bit-equal to JAX's), at 64 the baked K3."""
    ps = plib.many_light_scene(64)
    js = jlib.many_light_scene(64)
    assert ps.spheres.count == 66
    jr, pr = _rays(_centers(js.spheres), 300, 3)
    calls = []
    for name in ("spheres", "sphere_table"):
        real = getattr(k3, name)
        monkeypatch.setattr(k3, name, lambda *a, real=real, name=name: (
            calls.append(name), real(*a))[1])
    _assert_bit_equal(jmake(js.spheres, interpret=True)(jr),
                      k3.make_sphere_intersect(ps.spheres)(pr))
    k3.make_sphere_intersect(plib.many_light_scene(62).spheres)(pr)
    assert calls == ["sphere_table", "spheres"]


def test_sphere_table_ties_keep_lower_index():
    c = [(250.0, 180.0, 500.0)] * 2 + [(720.0, 160.0, 350.0)] * 70
    r = [180.0, 180.0] + [160.0] * 70
    m = [7, 9] + [8] * 70
    jr, pr = _rays(np.float32(c), 400, 5)
    jh = jmake_table(JSph.build(c, r, m), interpret=True)(jr)
    ph = k3.make_sphere_table_intersect(SpheresSoA.build(c, r, m))(pr)
    _assert_bit_equal(jh, ph)
    assert (ph.mati.numpy() != 9).all()         # the copy never wins


def test_many_light_scene_matches_jax():
    """Same rng stream: the lamp centres, radii and materials equal JAX's
    bit for bit, and so do the triangles and materials."""
    js, ps = jlib.many_light_scene(64, seed=3), plib.many_light_scene(64,
                                                                      seed=3)
    np.testing.assert_array_equal(_centers(ps.spheres), _centers(js.spheres))
    np.testing.assert_array_equal(ps.spheres.rad.numpy(),
                                  np.asarray(js.spheres.rad))
    np.testing.assert_array_equal(ps.spheres.mati.numpy(),
                                  np.asarray(js.spheres.mati))
    np.testing.assert_array_equal(ps.tris.r1.numpy(), np.asarray(js.tris.r1))
    for k in range(3):
        np.testing.assert_array_equal(ps.mats.emission[k].numpy(),
                                      np.asarray(js.mats.emission[k]))
    np.testing.assert_array_equal(ps.mats.type.numpy(),
                                  np.asarray(js.mats.type))


def test_sphere_lamp_scene_matches_jax():
    js = jlib.cornell_box(with_spheres=True, analytic_spheres=True,
                          sphere_lamp=True)
    ps = plib.cornell_box(with_spheres=True, analytic_spheres=True,
                          sphere_lamp=True)
    assert ps.tris.count == js.tris.count == 10
    np.testing.assert_array_equal(_centers(ps.spheres), _centers(js.spheres))
    np.testing.assert_array_equal(ps.spheres.mati.numpy(),
                                  np.asarray(js.spheres.mati))
    np.testing.assert_array_equal(ps.tris.n.numpy(), np.asarray(js.tris.n))


def test_k3_rounds_as_interpret_k3b_on_surface_rays():
    """Rays leaving the sphere-lamp box's three spheres 1e-3 off their
    surfaces (every bounce off a sphere): the port's K3 (plain version)
    equals interpret-mode K3b bit for bit, and interpret-mode K3, which
    rounds t through separate XLA fusions (ROADMAP.md queue 3), differs
    from both on some of them."""
    ps = plib.cornell_box(with_spheres=True, analytic_spheres=True,
                          sphere_lamp=True)
    js = jlib.cornell_box(with_spheres=True, analytic_spheres=True,
                          sphere_lamp=True)
    rs = np.random.default_rng(0)
    n = 2000
    c, r = _centers(js.spheres), np.asarray(js.spheres.rad, np.float32)
    which = rs.integers(0, 3, n)
    nrm = rs.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    side = np.where(rs.random(n) < 0.5, 1.0, -1.0)[:, None]
    p = (c[which] + nrm * r[which, None] + side * nrm * 1e-3).astype(
        np.float32)
    d = rs.normal(size=(n, 3))
    d *= np.sign((d * nrm).sum(1, keepdims=True)) * side
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    jr = JRays(p=tuple(jnp.asarray(p[:, k]) for k in range(3)),
               d=tuple(jnp.asarray(d[:, k]) for k in range(3)))
    pr = Rays(p=tuple(torch.from_numpy(p[:, k].copy()) for k in range(3)),
              d=tuple(torch.from_numpy(d[:, k].copy()) for k in range(3)))
    ph = k3.make_sphere_intersect(ps.spheres)(pr)
    _assert_bit_equal(jmake_table(js.spheres, interpret=True)(jr), ph)
    jk3 = np.asarray(jmake(js.spheres, interpret=True)(jr).t)
    assert (_bits(jk3) != _bits(ph.t.numpy())).sum() > 0
