"""The fifth slice as a whole on the CPU: stress_scene(1200) rendered by
the port and by the JAX package at 16x16 through the same pair
intersector (`PAIR_TPU_WINNER` with cluster_size 128 and trp 128; JAX in
interpret mode, the port with its plain versions): the megakernel model
(2 bounces, 2 spp) to the goldens' rtol 1e-4; with smooth shading (the
ids intersector and `smooth_hit_normals`), the colors to rtol 1e-4 and
the first hits' interpolated normals to atol 1e-6 (JAX normalises with
XLA's approximate rsqrt); and the wavefront model, ten steps."""

import jax
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.models import megakernel as jmk
from opencl_path_tracer_tpu.models import wavefront as jwf
from opencl_path_tracer_tpu.ops import shading as jshading
from opencl_path_tracer_tpu.ops.pallas import sorted_intersect as jsi
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.models import megakernel, wavefront
from opencl_path_tracer_tpu_torch.ops import rng
from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
from opencl_path_tracer_tpu_torch.ops.shading import smooth_hit_normals
from opencl_path_tracer_tpu_torch.scene import library
from test_torch_pair_intersect import _both, _camera_rays

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

W = H = 16
KW = dict(si.PAIR_TPU_WINNER, cluster_size=128, trp=128)


def _intersectors(smooth):
    js = jlib.stress_scene(1200, smooth=smooth)
    ps = library.stress_scene(1200, smooth=smooth)
    jf = jsi.make_pair_intersect(js.tris, interpret=True, with_ids=smooth,
                                 **KW)
    pf = si.make_pair_intersect(ps.tris, with_ids=smooth, **KW)
    if not smooth:
        return js, ps, jf, pf

    def jsmooth(rays):
        return jshading.smooth_hit_normals(*jf(rays), js.attribs)

    def psmooth(rays):
        return smooth_hit_normals(*pf(rays), ps.attribs)

    return js, ps, jsmooth, psmooth


@pytest.mark.parametrize("smooth", [False, True])
def test_stress_megakernel_matches_jax(smooth):
    js, ps, jf, pf = _intersectors(smooth)
    jst = jmk.render(jlib.cornell_camera(W, H), js.mats, intersect_fn=jf,
                     num_pixels=W * H, iterations=2, spp=2, mode="fast",
                     seed=5)
    pst = megakernel.render(library.cornell_camera(W, H), ps.mats,
                            intersect_fn=pf, num_pixels=W * H, iterations=2,
                            spp=2, mode="fast", seed=5, device="cpu")
    ref = np.asarray(jmk.colors_array(jst))
    got = megakernel.colors_array(pst).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    assert got.mean() > 0.0
    if smooth:
        jr, pr = _both(*_camera_rays())
        jh, ph = jf(jr), pf(pr)
        np.testing.assert_array_equal(ph.t.numpy(), np.asarray(jh.t))
        for a, b in zip(ph.n, jh.n):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)


def test_stress_wavefront_matches_jax():
    js, ps, jf, pf = _intersectors(False)
    jcam, pcam = jlib.cornell_camera(W, H), library.cornell_camera(W, H)
    jst = jwf.init_wavefront(jcam, W * H, mode="fast", key=jax.random.key(2))
    pst = wavefront.init_wavefront(pcam, W * H, mode="fast", key=rng.key(2))
    for _ in range(10):
        jst = jwf.wavefront_step(jcam, js.mats, jst, intersect_fn=jf,
                                 iterations=2, mode="fast",
                                 key=jax.random.key(2))
        pst = wavefront.wavefront_step(pcam, ps.mats, pst, intersect_fn=pf,
                                       iterations=2, mode="fast",
                                       key=rng.key(2))
    assert np.array_equal(pst.samples.numpy(), np.asarray(jst.samples))
    ref = np.stack([np.asarray(c) for c in jst.colors], -1)
    got = torch.stack(pst.colors, -1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    assert int(pst.samples.sum()) > W * H and got.mean() > 0.0
