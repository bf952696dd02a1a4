"""The plain reference and the benchmark's inputs agree with the port on
the CPU at 16 x 16 (the CUDA kernels have plain versions there)."""

import numpy as np
import pytest

from benchmark import compare, reference, run, scenes
from benchmark.manifest import Manifest
from opencl_path_tracer_tpu_torch.core.camera import make_camera
from opencl_path_tracer_tpu_torch.scene import library

SMALL = dict(width=16, height=16, pixels=256, spp_per_call=2, trace_spp=2,
             trace_frames=2)
LIBRARY = {"cornell-box": lambda: library.cornell_box(with_spheres=True),
           "stress-100k": lambda: library.stress_scene(100_000, seed=0)}


@pytest.mark.parametrize("name", sorted(LIBRARY))
def test_config_scene_is_the_library_scene(name):
    cfg = Manifest.load().config(name)
    arrays = scenes.build_scene(cfg)
    lib = LIBRARY[name]()
    v = np.stack([lib.tris.r1.numpy(), lib.tris.r2.numpy(),
                  lib.tris.r3.numpy()], 1)
    assert np.array_equal(arrays.v, v)
    assert np.array_equal(arrays.mat, lib.tris.mati.numpy())
    assert arrays.objects == [tuple(r) for r in lib.object_ranges.tolist()]


@pytest.mark.parametrize("cam", [(60.0, 0.0, 0.0, (0.0, 0.0, 0.0)),
                                 (75.0, -63.8, 15.6, (265.0, 162.3, 360.4))])
def test_camera_is_the_port_camera(cam):
    fov, yaw, pitch, shift = cam
    cfg = dict(width=64, height=48, camera=dict(fov=fov, yaw=yaw,
                                                pitch=pitch, shift=shift))
    mine = scenes.camera(cfg)
    port = make_camera(64, 48, fov, yaw, pitch, shift)
    for k in ("eye", "lookat", "up", "right"):
        assert np.array_equal(mine[k], getattr(port, k).numpy())


@pytest.mark.parametrize("cell", ["cornell-offline", "cornell-interactive",
                                  "cornell-nee-offline"])
@pytest.mark.parametrize("trace", [False, True])
def test_port_agrees_with_reference(cell, trace):
    res = run.run_cell(cell, 2 ** 31 + 12345, 0.05, trace, device="cpu",
                       overrides=SMALL)
    assert res["correct"], res["checks"]
    assert res["checks"]["image_rel_mae"]["value"] < 1e-5
    assert res["checks"]["sample_count_error"]["value"] == 0
    if cell == "cornell-interactive":
        assert res["checks"]["display_mae_levels"]["value"] <= 0.01


def test_uniforms_are_the_port_sampler():
    import torch
    from opencl_path_tracer_tpu_torch.ops import rng
    key = rng.fold_in(rng.key(987654321), 0)
    assert reference.sample_key(987654321) == key
    port = rng.fast_uniforms(key, 17, 3, 300, 2)
    pix = torch.arange(300)
    mine = reference.uniforms(key, pix, torch.full((300,), 17), 3, 2,
                              torch.float32)
    assert torch.equal(port[0], mine[0]) and torch.equal(port[1], mine[1])


def test_display_u8_is_the_port_display():
    import torch
    from opencl_path_tracer_tpu_torch.ops import tonemap
    rs = np.random.default_rng(3)
    c = np.concatenate([rs.exponential(2.0, (500, 3)), np.zeros((4, 3))])
    c = c.astype(np.float32)
    img = tonemap.apply(torch.as_tensor(c).reshape(1, -1, 3), "reinhard")
    img = torch.nan_to_num(img, nan=0.0, posinf=1.0, neginf=0.0)
    port = (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    mine = reference.display_u8(c)
    diff = np.abs(port.numpy().reshape(-1, 3).astype(int) - mine.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_check_pixels_from_the_seed():
    a = compare.check_pixels(5, 1000, 64)
    assert np.array_equal(a, compare.check_pixels(5, 1000, 64))
    assert len(set(a.tolist())) == 64 and np.all(np.diff(a) > 0)
    assert not np.array_equal(a, compare.check_pixels(6, 1000, 64))
    assert np.array_equal(compare.check_pixels(5, 10, 64), np.arange(10))


def test_judge():
    ok, checks = compare.judge({"a": 1.0, "b": 0}, {"a": 2.0, "b": 0})
    assert ok and checks["a"] == {"value": 1.0, "limit": 2.0}
    assert not compare.judge({"a": 3.0}, {"a": 2.0})[0]
    assert not compare.judge({"a": 1.0}, {"a": 2.0, "b": 0})[0]
