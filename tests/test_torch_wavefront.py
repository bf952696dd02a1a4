"""The port's wavefront model against the JAX package on the CPU:
init_wavefront and wavefront_step field by field from one state (fast
and parity modes, Russian roulette, lane sorting), the parity-mode claim
of config.py (wavefront with exact_spp is bit-identical to the
megakernel at equal spp), and colors_by_pixel with tile-major ids."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.models import wavefront as jwf
from opencl_path_tracer_tpu.ops.pallas.plucker_kernel import (
    make_minarg_intersect as jminarg,
)
from opencl_path_tracer_tpu.ops import raygen as jraygen
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import interop
from opencl_path_tracer_tpu_torch.models import megakernel, wavefront
from opencl_path_tracer_tpu_torch.ops import raygen, rng
from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

W = H = 16
# The tolerances of tests/test_torch_megakernel.py's oracle comparison.
RTOL, ATOL = 2e-5, 2e-6
V3_FIELDS = ("colors", "ray_p", "ray_d", "f_l", "f_b", "f_s", "f_r",
             "cur_color")
INT_FIELDS = ("samples", "pixel", "inside", "bounce")


def _setup():
    js = jlib.cornell_box(with_spheres=True)
    ps = library.cornell_box(with_spheres=True)
    # K1 + K2 on both sides (interpret mode in JAX): bit-equal hits.
    return (js, jlib.cornell_camera(W, H),
            jminarg(js.tris, tr=256, interpret=True),
            ps, library.cornell_camera(W, H),
            make_intersect_fn(ps, "bruteforce"))


def _to_port(jst):
    return interop.wavefront_state_from_numpy(
        {f: getattr(jst, f) for f in jst.__dataclass_fields__})


def _assert_state(p, jst, what):
    got = interop.wavefront_state_to_numpy(p)
    for name in V3_FIELDS:
        for k in range(3):
            np.testing.assert_allclose(got[name][k],
                                       np.asarray(getattr(jst, name)[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what}: {name}[{k}]")
    for name in INT_FIELDS:
        np.testing.assert_array_equal(got[name], np.asarray(getattr(jst, name)),
                                      err_msg=f"{what}: {name}")
    np.testing.assert_array_equal(got["rng_state"], np.asarray(jst.rng_state),
                                  err_msg=f"{what}: rng_state")
    assert got["step"] == int(jst.step), what


@pytest.mark.parametrize("mode", ["fast", "parity"])
def test_init_and_steps_match_jax(mode):
    js, jcam, jis, ps, pcam, pis = _setup()
    n = W * H
    jst = jwf.init_wavefront(jcam, n, mode=mode, key=jax.random.key(5))
    pst = wavefront.init_wavefront(pcam, n, mode=mode, key=rng.key(5))
    _assert_state(pst, jst, "init")
    for s in range(4):
        pst = wavefront.wavefront_step(
            pcam, ps.mats, _to_port(jst), intersect_fn=pis, iterations=3,
            mode=mode, key=rng.key(5))
        jst = jwf.wavefront_step(jcam, js.mats, jst, intersect_fn=jis,
                                 iterations=3, mode=mode,
                                 key=jax.random.key(5))
        _assert_state(pst, jst, f"step {s}")
    assert int(jnp.sum(jst.samples)) > 0


def test_rr_and_sort_every_match_jax():
    js, jcam, jis, ps, pcam, pis = _setup()
    n = W * H
    verts = np.concatenate([np.asarray(js.tris.r1), np.asarray(js.tris.r2),
                            np.asarray(js.tris.r3)])
    lo = verts.min(0)
    inv = 1.0 / np.maximum(verts.max(0) - lo, 1e-12)
    bounds = (tuple(float(v) for v in lo), tuple(float(v) for v in inv))
    kw = dict(iterations=4, mode="fast", rr=(1, 0.3), sort_every=2,
              scene_bounds=bounds)
    jst = jwf.init_wavefront(jcam, n, mode="fast", key=jax.random.key(9))
    sorted_once = False
    for s in range(5):
        pst = wavefront.wavefront_step(pcam, ps.mats, _to_port(jst),
                                       intersect_fn=pis, key=rng.key(9), **kw)
        before = np.asarray(jst.pixel)
        jst = jwf.wavefront_step(jcam, js.mats, jst, intersect_fn=jis,
                                 key=jax.random.key(9), **kw)
        sorted_once |= not np.array_equal(before, np.asarray(jst.pixel))
        _assert_state(pst, jst, f"step {s}")
    assert sorted_once                        # the lanes really moved
    assert int(jnp.sum(jst.samples)) > 0


def test_parity_wavefront_bit_identical_to_megakernel():
    """config.py's claim, in the port: parity-mode wavefront with
    exact_spp equals the megakernel at equal per-pixel spp, bit for bit."""
    w = h = 12
    scene = library.cornell_box(with_spheres=True)
    cam = library.cornell_camera(w, h)
    isect = make_intersect_fn(scene)
    mk = megakernel.render(cam, scene.mats, intersect_fn=isect,
                           num_pixels=w * h, iterations=3, spp=3,
                           mode="parity", device="cpu")
    ids = raygen.tile_major_ids(w, h, 4, 4)
    wf = wavefront.render_wavefront(cam, scene.mats, intersect_fn=isect,
                                    num_pixels=w * h, iterations=3,
                                    min_spp=3, mode="parity",
                                    exact_spp=True, ids=ids, device="cpu")
    assert int(wf.samples.min()) == int(wf.samples.max()) == 3
    assert torch.equal(wavefront.colors_by_pixel(wf, w * h),
                       megakernel.colors_array(mk))


def test_tile_major_ids_and_colors_by_pixel():
    w, h = 32, 16
    ids = raygen.tile_major_ids(w, h, 16, 8)
    jids = np.asarray(jraygen.tile_major_ids(w, h, 16, 8))
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(raygen.inverse_permutation(ids).numpy(),
                                  np.asarray(jraygen.inverse_permutation(
                                      jnp.asarray(jids))))
    with pytest.raises(ValueError):
        raygen.tile_major_ids(30, 16, 16, 8)
    scene = library.cornell_box(with_spheres=True)
    cam = library.cornell_camera(w, h)
    isect = make_intersect_fn(scene)
    # One lane per pixel (scatter), then two lanes per pixel (weighted).
    for lane_ids in (ids, torch.cat([ids, ids])):
        st = wavefront.init_wavefront(cam, lane_ids.shape[0], mode="fast",
                                      key=rng.key(2), ids=lane_ids)
        for _ in range(4):
            st = wavefront.wavefront_step(cam, scene.mats, st,
                                          intersect_fn=isect, iterations=2,
                                          mode="fast", key=rng.key(2))
        f = interop.wavefront_state_to_numpy(st)
        jst = jwf.WavefrontState(**{
            k: (tuple(jnp.asarray(c) for c in v) if isinstance(v, tuple)
                else jnp.asarray(v)) for k, v in f.items()})
        got = wavefront.colors_by_pixel(st, w * h).numpy()
        np.testing.assert_allclose(got, jwf.colors_by_pixel(jst, w * h),
                                   rtol=1e-6, atol=0)
        assert got.max() > 0


def test_unported_options_raise():
    """The environment, DOF and textures are ported: a textured intersector
    (one returning (Hits, kd)) steps, its kd multiplying the material's
    (by 1 here: the same state as the plain intersector's); an env of
    another type is refused."""
    scene = library.cornell_box(with_spheres=False)
    cam = library.cornell_camera(4, 4)
    st = wavefront.init_wavefront(cam, 16, mode="fast", key=rng.key(1))
    isect = make_intersect_fn(scene)

    def textured(rays):
        return isect(rays), (1.0, 1.0, 1.0)

    a, b = (wavefront.wavefront_step(cam, scene.mats, st, intersect_fn=fn,
                                     iterations=2, mode="fast",
                                     key=rng.key(1))
            for fn in (textured, isect))
    for k in range(3):
        assert torch.equal(a.colors[k], b.colors[k])
        assert torch.equal(a.f_l[k], b.f_l[k])
    assert torch.equal(a.samples, b.samples)

    def dark(rays):
        n = rays.count
        return isect(rays), tuple(torch.full((n,), 0.5) for _ in range(3))

    c = wavefront.wavefront_step(cam, scene.mats, st, intersect_fn=dark,
                                 iterations=2, mode="fast", key=rng.key(1))
    assert not torch.equal(c.f_l[0], b.f_l[0])
    with pytest.raises(TypeError, match="EnvLight"):
        wavefront.wavefront_step(cam, scene.mats, st, intersect_fn=isect,
                                 iterations=2, mode="fast", key=rng.key(1),
                                 env=object())
    out = wavefront.wavefront_step(cam, scene.mats, st, intersect_fn=isect,
                                   iterations=2, mode="fast", key=rng.key(1),
                                   env=megakernel.EnvLight(), dof=(1.0, 2.0))
    assert out.step == 2


def _nee_setup(sphere_lamp):
    """JAX (interpret-mode minarg, and interpret-mode K3b merged in: the
    port's K3 rounds as K3b does on rays that start at a sphere's surface,
    where interpret-mode K3 rounds through separate XLA fusions; ROADMAP.md
    queue 3) and the port (plain K1 + K2, plain K3) on one scene, with both
    emitter tables."""
    from opencl_path_tracer_tpu.ops import intersect as jisect
    from opencl_path_tracer_tpu.ops import nee as jnee
    from opencl_path_tracer_tpu.ops.pallas.sphere_kernel import (
        make_sphere_table_intersect as jsph,
    )
    from opencl_path_tracer_tpu_torch.ops import nee
    kw = (dict(with_spheres=True, analytic_spheres=True, sphere_lamp=True)
          if sphere_lamp else dict(with_spheres=True))
    js, ps = jlib.cornell_box(**kw), library.cornell_box(**kw)
    jis = jminarg(js.tris, tr=256, interpret=True)
    if sphere_lamp:
        jtri, jsp = jis, jsph(js.spheres, interpret=True)

        def jis(rays):
            return jisect.merge_hits(jtri(rays), jsp(rays))

    return (js, jis, jnee.build_emitter_table(js.tris, js.mats, js.spheres),
            ps, make_intersect_fn(ps, "bruteforce"),
            nee.build_emitter_table(ps.tris, ps.mats, ps.spheres))


@pytest.mark.parametrize("sphere_lamp", [False, True])
def test_nee_steps_match_jax(sphere_lamp):
    """Six NEE steps, each from JAX's state, field by field (integers
    exact, floats rtol 2e-5, prev_pdf included)."""
    js, jis, jtab, ps, pis, ptab = _nee_setup(sphere_lamp)
    jcam, pcam = jlib.cornell_camera(W, H), library.cornell_camera(W, H)
    n = W * H
    jst = jwf.init_wavefront(jcam, n, mode="fast", key=jax.random.key(4))
    for s in range(6):
        pst = wavefront.wavefront_step(
            pcam, ps.mats, _to_port(jst), intersect_fn=pis, iterations=4,
            mode="fast", key=rng.key(4), nee=ptab)
        jst = jwf.wavefront_step(jcam, js.mats, jst, intersect_fn=jis,
                                 iterations=4, mode="fast",
                                 key=jax.random.key(4), nee=jtab)
        _assert_state(pst, jst, f"step {s}")
        np.testing.assert_allclose(pst.prev_pdf.numpy(),
                                   np.asarray(jst.prev_pdf), rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {s}: prev_pdf")
    assert int(jnp.sum(jst.samples)) > 0
    assert float(np.asarray(jst.prev_pdf).max()) > 0.0


def test_nee_anyhit_route_bit_identical():
    """In the port's wavefront, shadow rays through K7 (or-ed with the
    spheres) give the same bits as through the nearest-hit intersector."""
    from opencl_path_tracer_tpu_torch.ops.kernels.tilecull_kernel import (
        make_scene_occluded,
    )
    _, _, _, ps, pis, ptab = _nee_setup(True)
    cam = library.cornell_camera(W, H)

    def run(occluded_fn):
        st = wavefront.init_wavefront(cam, W * H, mode="fast",
                                      key=rng.key(6))
        for _ in range(6):
            st = wavefront.wavefront_step(
                cam, ps.mats, st, intersect_fn=pis, iterations=4,
                mode="fast", key=rng.key(6), nee=ptab,
                occluded_fn=occluded_fn)
        return st

    a, b = run(None), run(make_scene_occluded(ps))
    for k in range(3):
        assert torch.equal(a.colors[k], b.colors[k])
        assert torch.equal(a.cur_color[k], b.cur_color[k])
    assert float(a.colors[0].max()) > 0.0
