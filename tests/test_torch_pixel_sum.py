"""The pixel sums with several lanes a pixel add in lane order
(`models/wavefront.py::pixel_sum`): the order of CPU `index_add_` and
of the JAX package's `np.add.at`, so the same bits on every device and
run. CUDA's atomic `index_add_` added in arrival order, which moved
float32 sums and pixels of `display_u8_device` between runs on the H100
(PERF.md section 6). Pinned here on the CPU: against `np.add.at` and
`index_add_` on seeded layouts, `colors_by_pixel` against JAX's, and the
engine's uint8 display against a lane-order reference."""

import types

import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.models import wavefront as jwf
from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.models import wavefront
from opencl_path_tracer_tpu_torch.ops import raygen, rng, tonemap
from opencl_path_tracer_tpu_torch.runtime.engine import (
    RenderEngine, make_intersect_fn,
)
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)


def _layout(seed, n, lanes):
    """Pixel ids of `lanes` lanes a pixel (some pixels with fewer, some
    with none), in a seeded order."""
    rs = np.random.default_rng(seed)
    pix = np.repeat(np.arange(n), rs.integers(0, lanes + 1, n))
    return rs.permutation(pix)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("cols", [None, 3])
@pytest.mark.parametrize("seed,n,lanes", [(0, 50, 4), (1, 7, 9), (2, 300, 1)])
def test_pixel_sum_adds_in_lane_order(dtype, cols, seed, n, lanes):
    pix = _layout(seed, n, lanes)
    rs = np.random.default_rng(seed + 10)
    shape = (pix.shape[0],) if cols is None else (pix.shape[0], cols)
    # Magnitudes far apart, so that the order of the adds shows.
    vals = (rs.normal(size=shape) * 10.0 ** rs.integers(-6, 7, shape)).astype(
        dtype)
    ref = np.zeros((n,) + shape[1:], dtype)
    np.add.at(ref, pix, vals)
    got = wavefront.pixel_sum(torch.from_numpy(pix), torch.from_numpy(vals),
                              n)
    np.testing.assert_array_equal(got.numpy(), ref)
    old = torch.zeros(got.shape, dtype=got.dtype).index_add_(
        0, torch.from_numpy(pix), torch.from_numpy(vals))
    assert torch.equal(got, old)
    assert wavefront.pixel_sum(torch.zeros(0, dtype=torch.long),
                               torch.zeros((0,) + shape[1:]), n).shape[0] == n


def _multi_lane_state(w, h, lanes, steps, seed):
    scene = library.cornell_box(with_spheres=True, analytic_spheres=True)
    cam = library.cornell_camera(w, h)
    isect = make_intersect_fn(scene, "minarg")
    key = rng.key(1)
    ids = raygen.pixel_ids_like(w * h).repeat_interleave(lanes)
    st = wavefront.init_wavefront(cam, w * h * lanes, mode="fast", key=key,
                                  ids=ids)
    for _ in range(steps):
        st = wavefront.wavefront_step(cam, scene.mats, st, intersect_fn=isect,
                                      iterations=3, mode="fast", key=key)
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(
        w * h * lanes))
    return scene, wavefront._lanes(st, lambda x: x[perm])


def test_colors_by_pixel_several_lanes_equals_jax():
    w, h = 8, 6
    _, st = _multi_lane_state(w, h, 4, 7, 3)
    assert int(st.samples.min()) >= 1
    ref = jwf.colors_by_pixel(types.SimpleNamespace(
        pixel=st.pixel.numpy(), samples=st.samples.numpy(),
        colors=tuple(c.numpy() for c in st.colors)), w * h)
    np.testing.assert_array_equal(
        wavefront.colors_by_pixel(st, w * h).numpy(), ref)


def test_display_u8_several_lanes_adds_in_lane_order():
    w, h = 8, 6
    scene, st = _multi_lane_state(w, h, 3, 6, 4)
    eng = RenderEngine(scene, RenderConfig(
        width=w, height=h, iterations=3, mode="fast", model="wavefront",
        accel="minarg", camera=CameraConfig(fov=60.0, yaw=0.0, pitch=0.0,
                                            shift=(0.0, 0.0, 0.0))),
        device="cpu")
    eng.state = st
    pix = st.pixel.numpy()
    wgt = st.samples.numpy().astype(np.float32)
    den = np.zeros(w * h, np.float32)
    np.add.at(den, pix, wgt)
    num = np.zeros((w * h, 3), np.float32)
    np.add.at(num, pix, wgt[:, None] * torch.stack(st.colors, -1).numpy())
    img = torch.from_numpy(num / np.maximum(den, 1.0)[:, None])
    img = tonemap.apply(img.reshape(h, w, 3), eng.cfg.tonemap)
    img = torch.nan_to_num(img, nan=0.0, posinf=1.0, neginf=0.0)
    ref = (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    assert torch.equal(eng.display_u8_device(), ref)
