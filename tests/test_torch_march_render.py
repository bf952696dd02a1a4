"""The seventh slice's 'march' (K18 + K18m, K4 tail) and 'flat' (K18
round 0, K19, K4 tail) accels as a whole on the CPU: 16x16 renders of the
Cornell box through the port's RenderEngine and the JAX package's at the
engines' own accel defaults (JAX in interpret mode), in the megakernel
model (2 bounces, 2 spp, fast mode), to the goldens' rtol 1e-4;
`ptx-torch render --accel march|flat`; and smooth
shading refused for both, as the JAX package refuses it."""

import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.runtime import engine as jengine
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import cli
from opencl_path_tracer_tpu_torch.runtime import engine
from opencl_path_tracer_tpu_torch.scene import library
from test_torch_cluster_render import render_both

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)


@pytest.mark.parametrize("accel", ["march", "flat"])
def test_engine_render_matches_jax(accel):
    jimg, pimg = render_both(jlib.cornell_box(with_spheres=True),
                             library.cornell_box(with_spheres=True), accel,
                             "megakernel")
    np.testing.assert_allclose(pimg, jimg, rtol=1e-4, atol=1e-6)
    assert pimg.shape == (16, 16, 3) and pimg.mean() > 0.0


@pytest.mark.parametrize("accel", ["march", "flat"])
def test_cli_render(accel, tmp_path, capsys):
    out = tmp_path / f"{accel}.png"
    rc = cli.main(["render", "--scene", "cornell", "--accel", accel,
                   "--size", "16x16", "--spp", "1", "--device", "cpu",
                   "--out", str(out)])
    assert rc == 0 and out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "on cpu" in capsys.readouterr().err


@pytest.mark.parametrize("accel", ["march", "flat"])
def test_smooth_refused_as_in_jax(accel):
    js = jlib.cornell_box(with_spheres=True, smooth_spheres=True)
    ps = library.cornell_box(with_spheres=True, smooth_spheres=True)
    with pytest.raises(ValueError) as jerr:
        jengine.make_intersect_fn(js, accel, smooth=True)
    with pytest.raises(ValueError) as perr:
        engine.make_intersect_fn(ps, accel, smooth=True)
    for err in (jerr, perr):
        assert accel in str(err.value) and "pairwin" in str(err.value)
