"""The port's entry points on the CPU: RenderEngine, the `ptx-torch`
CLI, the config's refusals, the accel choice, and the rule that nothing
runs on the CPU unless asked: without a GPU, an entry point called
without device="cpu" raises."""

import dataclasses
import tomllib

import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu_torch import cli
from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.io.image import write_png
from opencl_path_tracer_tpu_torch.models import megakernel
from opencl_path_tracer_tpu_torch.runtime import engine
from opencl_path_tracer_tpu_torch.scene import builder, library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

CORNELL_CAM = CameraConfig(fov=60.0, yaw=0.0, pitch=0.0,
                           shift=(0.0, 0.0, 0.0))


def _cfg(**kw):
    base = dict(width=16, height=12, iterations=3, spp=2, camera=CORNELL_CAM)
    base.update(kw)
    return RenderConfig(**base)


@pytest.mark.parametrize("scene_kw", [dict(with_spheres=True),
                                      dict(with_spheres=True,
                                           analytic_spheres=True)])
@pytest.mark.parametrize("mode", ["fast", "parity"])
def test_engine_renders_on_cpu(scene_kw, mode, tmp_path):
    eng = engine.RenderEngine(library.cornell_box(**scene_kw),
                              _cfg(mode=mode), device="cpu")
    eng.render(2)
    img = eng.image()
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    assert 0.0 < img.mean() <= 1.0
    assert eng.state.sample == 2
    assert 0 < eng.rays_traced <= 2 * 3 * 16 * 12
    eng.save_png(str(tmp_path / "e.png"))
    assert (tmp_path / "e.png").stat().st_size > 0


def test_engine_qmc_fast_mode():
    eng = engine.RenderEngine(library.cornell_box(), _cfg(qmc=True),
                              device="cpu")
    eng.render(1)
    assert np.isfinite(eng.image()).all()


@pytest.mark.parametrize("scene", ["cornell", "cornell-analytic"])
def test_cli_render_writes_png(scene, tmp_path, capsys):
    out = tmp_path / "r.png"
    rc = cli.main(["render", "--scene", scene, "--size", "16x16", "--spp",
                   "2", "--device", "cpu", "--out", str(out)])
    assert rc == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "on cpu" in capsys.readouterr().err


def test_entry_points_refuse_cpu_without_asking(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = library.cornell_box(with_spheres=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.RenderEngine(scene, _cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        megakernel.render(library.cornell_camera(4, 4), scene.mats,
                          intersect_fn=engine.make_intersect_fn(scene),
                          num_pixels=16, iterations=1, spp=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["render", "--size", "8x8", "--spp", "1", "--out",
                  str(tmp_path / "x.png")])
    engine.RenderEngine(scene, _cfg(), device="cpu").render(1)


@pytest.mark.parametrize("field,value", [
    ("devices", 2), ("accel_force", True), ("textured", True)],
    ids=["devices-2", "accel_force-True", "textured-True"])
def test_config_refuses_unported_fields(field, value):
    """Every field of the JAX package's config is ported (the UNPORTED
    list is gone): devices, accel_force and textured validate and
    round-trip through JSON; devices=-1 is refused with the JAX package's
    message."""
    assert not hasattr(RenderConfig, "UNPORTED")
    cfg = dataclasses.replace(_cfg(), **{field: value})
    assert getattr(cfg.validate(), field) == value
    assert RenderConfig.from_json(cfg.to_json()) == cfg
    with pytest.raises(ValueError, match=r"devices must be >= 0 \(0 = all\)"):
        _cfg(devices=-1).validate()


def test_config_validation_and_json_roundtrip():
    for accel in ("bvh", "median", "pairmx"):
        assert _cfg(accel=accel).validate().accel == accel
    with pytest.raises(ValueError, match="unknown accel"):
        _cfg(accel="kdtree").validate()
    assert _cfg(accel="pairwin").validate().accel == "pairwin"
    assert _cfg(accel="march").validate().accel == "march"
    assert _cfg(accel="flat").validate().accel == "flat"
    with pytest.raises(ValueError):
        _cfg(mode="parity", qmc=True).validate()
    with pytest.raises(ValueError):
        _cfg(iterations=0).validate()
    cfg = _cfg(mode="parity", seed=5)
    back = RenderConfig.from_json(cfg.to_json())
    assert back == cfg


def test_config_wavefront_and_roulette_checks():
    _cfg(model="wavefront", rr_start=2, rr_pmin=0.1).validate()
    with pytest.raises(ValueError, match="unknown model"):
        _cfg(model="fused").validate()
    with pytest.raises(ValueError, match="needs model='wavefront'"):
        _cfg(rr_start=2).validate()
    with pytest.raises(ValueError, match="rr_start"):
        _cfg(model="wavefront", rr_start=0).validate()
    with pytest.raises(ValueError, match="rr_pmin"):
        _cfg(model="wavefront", rr_start=1, rr_pmin=0.0).validate()
    cfg = _cfg(model="wavefront", rr_start=3, accel="pallas")
    assert RenderConfig.from_json(cfg.to_json()) == cfg


@pytest.mark.parametrize("mode", ["fast", "parity"])
def test_engine_wavefront_model_on_cpu(mode):
    """Every pixel gets exactly spp samples; rays are lanes x steps;
    a second render call continues to the new target."""
    eng = engine.RenderEngine(library.cornell_box(with_spheres=True,
                                                  analytic_spheres=True),
                              _cfg(model="wavefront", mode=mode),
                              device="cpu")
    eng.render(2)
    assert int(eng.state.samples.min()) == int(eng.state.samples.max()) == 2
    assert eng.rays_traced == eng.steps_run * 16 * 12
    assert 2 <= eng.steps_run <= 2 * 3 + 16
    eng.render(1)
    assert int(eng.state.samples.min()) == int(eng.state.samples.max()) == 3
    img = eng.image()
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    assert 0.0 < img.mean() <= 1.0


def test_cli_render_wavefront_with_roulette(tmp_path, capsys):
    out = tmp_path / "w.png"
    rc = cli.main(["render", "--scene", "cornell", "--size", "16x16", "--spp",
                   "2", "--model", "wavefront", "--rr", "2", "--accel",
                   "pallas", "--device", "cpu", "--out", str(out)])
    assert rc == 0 and out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "on cpu" in capsys.readouterr().err


def test_accel_resolution():
    assert engine.resolve_accel("auto", 804, on_cuda=True) == "minarg"
    assert engine.resolve_accel("auto", 8192, on_cuda=False) == "minarg"
    assert engine.resolve_accel("auto", 8193, on_cuda=True) == "pairwin"
    assert engine.resolve_accel("auto", 99_380, on_cuda=False) == "pairwin"
    assert engine.resolve_accel("pairwin", 10, on_cuda=True) == "pairwin"
    with pytest.raises(ValueError, match="bruteforce"):
        engine.resolve_accel("bruteforce", 10, on_cuda=True)
    assert engine.resolve_accel("bruteforce", 10, on_cuda=False) == \
        "bruteforce"
    assert engine.resolve_accel("pallas", 10, on_cuda=True) == "pallas"
    assert engine.resolve_accel("tilecull", 10, on_cuda=True) == "tilecull"
    assert engine.resolve_accel("march", 99_380, on_cuda=True) == "march"
    assert engine.resolve_accel("flat", 10, on_cuda=False) == "flat"
    # The walkers run on CUDA only with force; on the CPU always.
    for accel in ("bvh", "median"):
        with pytest.raises(ValueError, match="force=True"):
            engine.resolve_accel(accel, 10, on_cuda=True)
        assert engine.resolve_accel(accel, 10, on_cuda=True,
                                    force=True) == accel
        assert engine.resolve_accel(accel, 10, on_cuda=False) == accel
    assert engine.resolve_accel("pairmx", 10, on_cuda=True) == "pairmx"


def test_console_script_and_package_data_declared():
    with open("pyproject.toml", "rb") as fh:
        proj = tomllib.load(fh)
    assert (proj["project"]["scripts"]["ptx-torch"]
            == "opencl_path_tracer_tpu_torch.cli:main")
    data = proj["tool"]["setuptools"]["package-data"][
        "opencl_path_tracer_tpu_torch"]
    assert "csrc/*.cu" in data and "csrc/*.cuh" in data


def test_write_png_accepts_engine_image(tmp_path):
    eng = engine.RenderEngine(library.cornell_box(with_spheres=False),
                              _cfg(iterations=1), device="cpu")
    eng.render(1)
    write_png(str(tmp_path / "i.png"), eng.image())


@pytest.mark.parametrize("model", ["megakernel", "wavefront"])
@pytest.mark.parametrize("scene,kw", [
    ("cornell", dict(nee=True)),
    ("cornell", dict(nee=True, nee_anyhit=False)),
    ("cornell-sphere-lamp", dict(nee=True)),
    ("many-lights-8", dict(nee=True, nee_select="distance")),
    ("cornell", dict(accel="tilecull")),
])
def test_engine_nee_and_tilecull_on_cpu(model, scene, kw):
    """NEE (both selects, both shadow-ray routes) and accel='tilecull'
    through the engine in both models; the any-hit route is built unless
    nee_anyhit is off, and the megakernel counts the shadow batch."""
    eng = engine.RenderEngine(cli._build_scene(scene, "cpu"),
                              _cfg(model=model, **kw), device="cpu")
    assert (eng.nee is not None) == kw.get("nee", False)
    assert (eng.occluded is not None) == (kw.get("nee", False)
                                          and kw.get("nee_anyhit", True))
    eng.render(2)
    img = eng.image()
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    assert 0.0 < img.mean() <= 1.0
    if model == "wavefront":   # lanes x steps, as the JAX engine counts
        assert eng.rays_traced == eng.steps_run * 16 * 12
    else:                      # live lanes, twice with the shadow batch
        per_bounce = 2 if kw.get("nee") else 1
        assert 0 < eng.rays_traced <= per_bounce * 2 * 3 * 16 * 12


def test_engine_nee_anyhit_route_bit_identical():
    """nee_anyhit=True (K7) and False (the nearest-hit intersector) give
    the same image bits, and nee changes the image."""
    imgs = []
    for kw in (dict(nee=True), dict(nee=True, nee_anyhit=False), {}):
        eng = engine.RenderEngine(library.cornell_box(), _cfg(**kw),
                                  device="cpu")
        eng.render(1)
        imgs.append(eng.image(apply_tonemap=False))
    assert np.array_equal(imgs[0], imgs[1])
    assert not np.array_equal(imgs[0], imgs[2])


def test_config_nee_checks():
    _cfg(nee=True, nee_select="distance", nee_anyhit=False).validate()
    with pytest.raises(ValueError, match="nee_select"):
        _cfg(nee=True, nee_select="nearest").validate()
    cfg = _cfg(nee=True, nee_select="distance", accel="tilecull")
    assert RenderConfig.from_json(cfg.to_json()) == cfg
    with pytest.raises(ValueError, match="distance"):
        engine.RenderEngine(library.cornell_box(),
                            _cfg(nee=True, nee_select="distance"),
                            device="cpu")


@pytest.mark.parametrize("args", [
    ["--scene", "cornell", "--nee"],
    ["--scene", "many-lights-8", "--nee", "--nee-select", "distance"],
    ["--scene", "cornell-sphere-lamp", "--nee", "--no-nee-anyhit",
     "--model", "wavefront"],
    ["--scene", "cornell", "--accel", "tilecull"],
])
def test_cli_render_nee_and_tilecull(args, tmp_path, capsys):
    out = tmp_path / "n.png"
    rc = cli.main(["render", "--size", "16x12", "--spp", "1", "--iters", "3",
                   "--device", "cpu", "--out", str(out), *args])
    assert rc == 0 and out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "on cpu" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="many-lights"):
        cli._build_scene("no-such-scene", "cpu")


def test_smooth_accel_choice_and_refusals():
    """accel='auto' with smooth shading is 'minarg' up to the JAX
    package's 4,096-triangle cap and the pair route ('pairwin' with ids)
    above; 'pallas' (no winner index) and a scene without vertex normals
    are refused."""
    assert engine.resolve_accel("auto", 4096, True, smooth=True) == "minarg"
    assert engine.resolve_accel("auto", 4097, True, smooth=True) == "pairwin"
    assert engine.resolve_accel("pairwin", 10, True, smooth=True) == \
        "pairwin"
    smooth = library.cornell_box(with_spheres=True, smooth_spheres=True)
    with pytest.raises(ValueError, match="winner's index"):
        engine.make_intersect_fn(smooth, "pallas", smooth=True)
    with pytest.raises(ValueError, match="no vertex normals"):
        engine.make_intersect_fn(library.cornell_box(), smooth=True)
    b = builder.SceneBuilder()
    b.add_material_row(library.reference_archetypes()[2])
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), 0,
                   uv=((0, 0), (1, 0), (0, 1)))
    uv_only = b.build()
    assert uv_only.attribs is not None
    with pytest.raises(ValueError, match="no vertex normals"):
        engine.make_intersect_fn(uv_only, smooth=True)
    big = library.cornell_box(with_spheres=True, smooth_spheres=True,
                              sphere_res=(40, 60))
    assert big.num_triangles > engine.SMOOTH_MINARG_MAX_TRIS
    with pytest.raises(ValueError, match="4096"):
        engine.make_intersect_fn(big, "minarg", smooth=True)
    cfg = _cfg(smooth=True, accel="tilecull")
    assert RenderConfig.from_json(cfg.to_json()) == cfg


@pytest.mark.parametrize("model", ["megakernel", "wavefront"])
@pytest.mark.parametrize("accel", ["auto", "tilecull", "bruteforce"])
def test_engine_smooth_on_cpu(model, accel):
    """Smooth shading through the engine in both models and on each route
    that reports the winner's index; the smooth normals change the
    image."""
    scene = library.cornell_box(with_spheres=True, smooth_spheres=True)
    imgs = []
    for smooth in (True, False):
        eng = engine.RenderEngine(scene, _cfg(model=model, accel=accel,
                                              smooth=smooth), device="cpu")
        eng.render(2)
        imgs.append(eng.image(apply_tonemap=False))
    assert imgs[0].shape == (12, 16, 3) and np.isfinite(imgs[0]).all()
    assert imgs[0].mean() > 0.0
    assert not np.array_equal(imgs[0], imgs[1])
