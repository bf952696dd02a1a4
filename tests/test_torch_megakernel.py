"""The port's megakernel model end to end on the CPU, against the JAX
package: the three goldens at the tolerances of
tests/test_megakernel.py, the Lehmer end states of the scalar oracle
(exact) with its colors at tests/test_oracle.py's tolerances, a fast-mode
render against JAX's fast mode, and a render resumed from a JAX state."""

import functools

import jax
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.models import megakernel as jmk
from opencl_path_tracer_tpu.ops import intersect as jisect
from opencl_path_tracer_tpu.runtime.engine import make_intersect_fn as jmake
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu.utils import oracle
from opencl_path_tracer_tpu_torch import interop
from opencl_path_tracer_tpu_torch.models import megakernel
from opencl_path_tracer_tpu_torch.ops import rng
from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

GOLDENS = [
    ("cornell_16x16_i2_s4", dict(with_spheres=False), 2),
    ("cornell_spheres_16x16_i4_s4", dict(with_spheres=True), 4),
    ("cornell_analytic_16x16_i2_s4",
     dict(with_spheres=True, analytic_spheres=True), 2),
]


def _render(kw, w, h, iterations, spp, accel="auto", mode="parity",
            state=None):
    scene = library.cornell_box(**kw)
    cam = library.cornell_camera(w, h)
    return megakernel.render(cam, scene.mats,
                             intersect_fn=make_intersect_fn(scene, accel),
                             num_pixels=w * h, iterations=iterations,
                             spp=spp, mode=mode, state=state, device="cpu")


@pytest.mark.parametrize("accel", ["auto", "bruteforce"])
@pytest.mark.parametrize("name,kw,iterations", GOLDENS,
                         ids=[g[0] for g in GOLDENS])
def test_goldens(name, kw, iterations, accel):
    st = _render(kw, 16, 16, iterations, 4, accel=accel)
    img = megakernel.colors_array(st).numpy()
    golden = np.load(f"tests/golden/{name}.npy")
    stats = np.array([img.mean(), img.std(), img.max()])
    np.testing.assert_allclose(stats, golden[:3], rtol=1e-5)
    np.testing.assert_allclose(img.reshape(16, 16, 3),
                               golden[3:].reshape(16, 16, 3), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("iterations,spp", [(1, 1), (3, 2)])
def test_lehmer_end_states_match_oracle(iterations, spp):
    w = h = 8
    st = _render(dict(with_spheres=True), w, h, iterations, spp)
    ref_colors, ref_rng = oracle.render_oracle(
        jlib.cornell_box(with_spheres=True), jlib.cornell_camera(w, h),
        width=w, height=h, iterations=iterations, spp=spp, seed=1)
    np.testing.assert_array_equal(st.rng_state.numpy().astype(np.uint32),
                                  ref_rng)
    np.testing.assert_allclose(megakernel.colors_array(st).numpy(),
                               ref_colors, rtol=2e-5, atol=2e-6)


def test_fast_mode_matches_jax_fast_mode():
    """Same keys, same draws (bit-equal), so the same paths: the images
    agree to the goldens' tolerance."""
    w = h = 16
    js = jlib.cornell_box(with_spheres=True)
    jst = jmk.render(jlib.cornell_camera(w, h), js.mats,
                     intersect_fn=functools.partial(jisect.first_intersect,
                                                    tris=js.tris),
                     num_pixels=w * h, iterations=4, spp=2, mode="fast",
                     seed=3)
    scene = library.cornell_box(with_spheres=True)
    pst = megakernel.render(library.cornell_camera(w, h), scene.mats,
                            intersect_fn=make_intersect_fn(scene),
                            num_pixels=w * h, iterations=4, spp=2,
                            mode="fast", seed=3, device="cpu")
    np.testing.assert_allclose(megakernel.colors_array(pst).numpy(),
                               np.asarray(jmk.colors_array(jst)), rtol=1e-4,
                               atol=1e-6)


def test_resume_from_jax_state():
    """2 JAX samples + 2 port samples == 4 samples of the scalar oracle:
    Lehmer states exactly, colors to tests/test_oracle.py's tolerance;
    state_to_numpy round-trips."""
    w = h = 8
    kw = dict(with_spheres=True)
    js = jlib.cornell_box(**kw)
    cam = jlib.cornell_camera(w, h)
    j2 = jmk.render(cam, js.mats, intersect_fn=jmake(js, "bruteforce"),
                    num_pixels=w * h, iterations=3, spp=2, mode="parity")
    ref_colors, ref_rng = oracle.render_oracle(
        js, cam, width=w, height=h, iterations=3, spp=4, seed=1)
    st = interop.state_from_numpy(
        [np.asarray(c) for c in j2.colors], np.asarray(j2.rng_state),
        int(j2.sample))
    back = interop.state_to_numpy(st)
    np.testing.assert_array_equal(back["rng_state"], np.asarray(j2.rng_state))
    np.testing.assert_array_equal(back["colors"],
                                  np.asarray(jmk.colors_array(j2)))
    p4 = _render(kw, w, h, 3, 2, state=st)
    assert p4.sample == 4
    np.testing.assert_array_equal(p4.rng_state.numpy().astype(np.uint32),
                                  ref_rng)
    np.testing.assert_allclose(megakernel.colors_array(p4).numpy(),
                               ref_colors, rtol=2e-5, atol=2e-6)


def test_preview_and_determinism():
    a = _render(dict(with_spheres=True), 16, 16, 1, 1)
    img = megakernel.colors_array(a).numpy()
    assert np.isfinite(img).all() and img.max() > 1.0   # lamp pixels
    b = _render(dict(with_spheres=True), 16, 16, 1, 1)
    assert torch.equal(a.rng_state, b.rng_state)
    assert all(torch.equal(x, y) for x, y in zip(a.colors, b.colors))


def _nee_render(mode, select="power", w=16, h=16, iterations=4, spp=2,
                many=None, occluded=False):
    """The same NEE render in both packages: JAX's jitted megakernel with
    the interpret-mode minarg intersector (and, for spheres, interpret-mode
    K3b, whose rounding the port's K3 follows on rays that start at a
    sphere's surface; ROADMAP.md queue 3), the port's with K1 + K2 (and
    K3) plain versions."""
    from opencl_path_tracer_tpu.ops import nee as jnee
    from opencl_path_tracer_tpu.ops.pallas.plucker_kernel import (
        make_minarg_intersect as jminarg,
    )
    from opencl_path_tracer_tpu.ops.pallas.sphere_kernel import (
        make_sphere_table_intersect as jsph,
    )
    from opencl_path_tracer_tpu_torch.ops import nee
    from opencl_path_tracer_tpu_torch.ops.kernels.tilecull_kernel import (
        make_scene_occluded,
    )
    if many is None:
        js, ps = (jlib.cornell_box(with_spheres=True),
                  library.cornell_box(with_spheres=True))
    else:
        js, ps = jlib.many_light_scene(many), library.many_light_scene(many)
    jis = jminarg(js.tris, tr=256, interpret=True)
    if js.spheres is not None:
        jtri, jsp = jis, jsph(js.spheres, interpret=True)

        def jis(rays):
            return jisect.merge_hits(jtri(rays), jsp(rays))

    jst = jmk.render(jlib.cornell_camera(w, h), js.mats, intersect_fn=jis,
                     num_pixels=w * h, iterations=iterations, spp=spp,
                     mode=mode, seed=3,
                     nee=jnee.build_emitter_table(js.tris, js.mats,
                                                  js.spheres, select=select))
    pst = megakernel.init_state(w * h, 3)
    ptab = nee.build_emitter_table(ps.tris, ps.mats, ps.spheres,
                                   select=select)
    for _ in range(spp):
        pst = megakernel.trace_sample(
            library.cornell_camera(w, h), ps.mats, pst,
            intersect_fn=make_intersect_fn(ps), iterations=iterations,
            mode=mode, key=rng.key(3) if mode == "fast" else None, nee=ptab,
            occluded_fn=make_scene_occluded(ps) if occluded else None)
    return np.asarray(jmk.colors_array(jst)), megakernel.colors_array(pst)


@pytest.mark.parametrize("mode", ["fast", "parity"])
def test_nee_render_matches_jax(mode):
    """16x16 Cornell NEE renders, parity and fast, against JAX's at the
    goldens' tolerance; the Lehmer draws are NEE-free in both."""
    ref, got = _nee_render(mode)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-6)
    assert got.numpy().mean() > 0.0


def test_nee_distance_many_lights_matches_jax():
    """many-lights-8 (10 spheres) with the 'distance' select, against
    JAX's render run op by op (jax.disable_jit). The jitted JAX render is
    no reference here: XLA's approximate rsqrt in its normalisations
    moves single pixels of it by up to 49x from its own op-by-op render
    near the small lamps. Against the op-by-op render, 90 % of the values
    are bit-equal and 98 % within rtol 1e-4; the rest, within rtol 5e-2,
    are cone samples at the silhouette of a 10-22-unit lamp, where the
    forward hit turns an ulp of cos or sin (the two libraries round
    them differently) into a visible change."""
    with jax.disable_jit():
        ref, got = _nee_render("fast", select="distance", many=8, spp=1)
    got = got.numpy()
    np.testing.assert_allclose(got, ref, rtol=5e-2, atol=1e-6)
    assert (got == ref).mean() > 0.9
    assert (np.abs(got - ref) <= 1e-4 * np.abs(ref) + 1e-6).mean() > 0.98
    assert got.mean() > 0.0


def test_nee_anyhit_route_bit_identical():
    """Shadow rays through K7 (any-hit) give the same bits as through the
    nearest-hit intersector."""
    _, a = _nee_render("fast", w=12, h=12, spp=1)
    _, b = _nee_render("fast", w=12, h=12, spp=1, occluded=True)
    assert torch.equal(a, b)
