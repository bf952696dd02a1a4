"""The port's scalar prog.cl oracle (`utils/oracle.py`) on the CPU:
against the JAX package's oracle (colors and Lehmer end states bit-equal,
with and without the dormant sky light), and as the independent
reference of the port's parity megakernel (Lehmer end states exact,
colors at tests/test_oracle.py's rtol 2e-5, atol 2e-6)."""

import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.models import megakernel as jmk
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu.utils import oracle as joracle
from opencl_path_tracer_tpu_torch.models import megakernel
from opencl_path_tracer_tpu_torch.ops import rng
from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
from opencl_path_tracer_tpu_torch.scene import library
from opencl_path_tracer_tpu_torch.utils import oracle

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6   # tests/test_oracle.py's float32 rounding band


@pytest.mark.parametrize("env", [False, True], ids=["no-env", "env"])
def test_oracle_equals_jax_oracle(env):
    w = h = 8
    kw = dict(width=w, height=h, iterations=2, spp=2, seed=1)
    ours = oracle.render_oracle(
        library.cornell_box(with_spheres=True),
        library.cornell_camera(w, h),
        env=megakernel.EnvLight() if env else None, **kw)
    ref = joracle.render_oracle(
        jlib.cornell_box(with_spheres=True), jlib.cornell_camera(w, h),
        env=jmk.EnvLight() if env else None, **kw)
    np.testing.assert_array_equal(ours[1], ref[1])
    np.testing.assert_array_equal(ours[0], ref[0])
    assert ours[0].dtype == np.float32 and ours[1].dtype == np.uint32
    if env:
        # The sky reaches the image: the box is open towards the camera.
        plain = oracle.render_oracle(library.cornell_box(with_spheres=True),
                                     library.cornell_camera(w, h), **kw)
        assert not np.array_equal(plain[0], ours[0])


def test_oracle_pixel_subset_and_transcript():
    w = h = 8
    scene = library.cornell_box(with_spheres=False)
    cam = library.cornell_camera(w, h)
    pix = [0, 9, 27, 63]
    sub, seeds = oracle.render_oracle(scene, cam, width=w, height=h,
                                      iterations=3, spp=1, pixels=pix)
    full, full_seeds = oracle.render_oracle(scene, cam, width=w, height=h,
                                            iterations=3, spp=1)
    np.testing.assert_array_equal(sub[pix], full[pix])
    np.testing.assert_array_equal(seeds[pix], full_seeds[pix])
    rest = np.setdiff1d(np.arange(w * h), pix)
    assert not sub[rest].any()
    # The transcript of one pixel: gen_ray first, the seeds it logs chain.
    tr = oracle.OracleTrace(events=[])
    s = rng.minstd_rand0_raw(w * h, 1).astype(np.int64)
    oracle.trace_pixel(27, s, cam, oracle.scene_to_numpy(scene),
                       oracle.mats_to_numpy(scene.mats), 3, trace=tr)
    assert tr.events[0]["ev"] == "gen_ray"
    assert int(s[27]) == int(full_seeds[27])


@pytest.mark.parametrize("iterations,spp", [(1, 2), (2, 3), (5, 2)])
def test_parity_megakernel_matches_port_oracle(iterations, spp):
    w = h = 16
    scene = library.cornell_box(with_spheres=True)
    cam = library.cornell_camera(w, h)
    st = megakernel.render(
        cam, scene.mats, intersect_fn=make_intersect_fn(scene, "auto"),
        num_pixels=w * h, iterations=iterations, spp=spp, mode="parity",
        seed=1, device="cpu")
    colors, seeds = oracle.render_oracle(scene, cam, width=w, height=h,
                                         iterations=iterations, spp=spp,
                                         seed=1)
    np.testing.assert_array_equal(st.rng_state.numpy().astype(np.uint32),
                                  seeds)
    np.testing.assert_allclose(megakernel.colors_array(st).numpy(), colors,
                               rtol=RTOL, atol=ATOL)
