"""Every examples_torch/ twin runs on the CPU (`--device cpu`) at the
tiny sizes tests/test_examples.py gives the JAX scripts, in process
through its `main(argv)`, and prints the JAX script's marker line; one
runs as a subprocess as documented, one shows that a twin without
--device needs a GPU, and 05's counts equal the JAX script's logic."""

import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.ops import intersect as jisect
from opencl_path_tracer_tpu.ops import raygen as jraygen
from opencl_path_tracer_tpu.ops import rng as jrng
from opencl_path_tracer_tpu.scene import library as jlib

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = os.path.join(REPO, "examples_torch")


def twin(stem: str):
    """The twin module, imported by its file name (examples_torch/ on
    sys.path, so that 04's spawned ranks import it the same way)."""
    if TWINS not in sys.path:
        sys.path.insert(0, TWINS)
    return importlib.import_module(stem)


def run(capsys, stem, *args):
    """(main's return value, what it printed)."""
    ret = twin(stem).main([*args, "--device", "cpu"])
    return ret, capsys.readouterr().out


CASES = [
    ("01_render_cornell", ("--size", "32x32", "--spp", "2"), "out", "wrote"),
    ("02_custom_scene", ("--size", "32x32", "--spp", "2"), "out",
     "triangles"),
    ("06_smooth_and_spheres", ("--size", "32x32", "--spp", "2"), "out",
     "smooth-shaded"),
    ("07_uv_checker", ("--size", "48x48"), "out", "checker balance"),
    ("08_textured_obj", ("--size", "48x32", "--spp", "2"), "out",
     "1 texture"),
    ("09_environment_light", ("--size", "32x32", "--spp", "2"), "out",
     "env-lit"),
    # 8x6, not tests/test_examples.py's 32x24: the three renders take
    # about 400 wavefront steps, 0.42 s each at 32x24 on one CPU thread
    # (the plain minarg's float64 FMAs over 804 triangles), 0.02 at 8x6.
    ("10_nee_and_adaptive", ("--size", "8x6"), "out", "NEE+adaptive"),
    ("11_many_lights", ("--size", "32x24", "--lights", "6", "--spp", "3"),
     "out", "right: distance"),
    ("12_spectral_dispersion", ("--size", "32x24", "--spp", "3"), "out",
     "channel split"),
]


@pytest.mark.parametrize("stem,args,flag,marker", CASES,
                         ids=[c[0] for c in CASES])
def test_twin_writes_its_image(capsys, tmp_path, stem, args, flag, marker):
    png = str(tmp_path / f"{stem}.png")
    if stem == "02_custom_scene":
        # The OBJ default is relative to the repository's root.
        args += ("--obj", os.path.join(REPO, "tests/assets/models/"
                                             "sphere.obj"))
    _, out = run(capsys, stem, *args, f"--{flag}", png)
    assert marker in out, out
    assert os.path.getsize(png) > 0
    if stem == "02_custom_scene":
        assert "objects" in out and not out.startswith("4 triangles")


def test_twin_03_resume_is_bit_exact(capsys, tmp_path):
    ck = str(tmp_path / "e3.npz")
    _, out = run(capsys, "03_checkpoint_resume", "--size", "16x16", "--spp",
              "4", "--ckpt", ck)
    assert "bit-exact" in out and os.path.exists(ck)


def test_twin_04_over_two_gloo_ranks(capsys, tmp_path):
    """The file's one world: two gloo ranks on the CPU at 16x16."""
    png = str(tmp_path / "e4.png")
    launches, out = run(capsys, "04_multi_device", "--size", "16x16",
                        "--steps", "2", "--devices", "2", "--out", png)
    assert "mesh: 2 x cpu" in out and "wrote" in out
    assert launches == [{}, {}]   # plain versions: no kernel on the CPU
    assert os.path.getsize(png) > 0


def _jax_05_counts(w, h):
    """examples/05_low_level_ops.py's logic on the JAX package."""
    n = w * h
    scene = jlib.cornell_box(with_spheres=True)
    cam = jlib.cornell_camera(w, h)
    streams = jrng.seed_pixel_streams(n)
    ids = jraygen.pixel_ids(w, h)
    streams, u1 = jrng.lehmer_step(streams)
    streams, u2 = jrng.lehmer_step(streams)
    rays = jraygen.camera_rays(cam, ids, u1, u2)
    hits = jisect.first_intersect(rays, scene.tris)
    hit_mask = np.asarray(hits.t) >= 0.0
    m = scene.mats.take_select(jnp.maximum(hits.mati, 0))
    emissive = np.asarray(sum(m.emission)) > 0.0
    return (int(hit_mask.sum()), int((~hit_mask).sum()),
            int((emissive & hit_mask).sum()))


def test_twin_05_counts_equal_jax(capsys):
    _, out = run(capsys, "05_low_level_ops", "--size", "32x32")
    assert "ok" in out and "hits" in out
    hits, misses, lamps = _jax_05_counts(32, 32)
    assert f"1024 rays: {hits} hits, {misses} misses" in out
    assert f"lamp lanes: {lamps}\n" in out
    assert hits > 0 and lamps > 0   # a closed box: misses are 0


def test_twin_as_documented_subprocess(tmp_path):
    png = str(tmp_path / "e1.png")
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    res = subprocess.run(
        [sys.executable, os.path.join(TWINS, "01_render_cornell.py"),
         "--device", "cpu", "--size", "16x16", "--spp", "1", "--out", png],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-800:]
    assert "wrote" in res.stdout and os.path.getsize(png) > 0


def test_twin_without_device_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the twin would render on it")
    png = str(tmp_path / "e1.png")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin("01_render_cornell").main(["--size", "16x16", "--spp", "1",
                                        "--out", png])
    assert not os.path.exists(png)
