"""The sixth slice's 'pair' accel (the pair intersector at its own
defaults: K12 on clusters of 512) as a whole on the CPU: 16x16 renders of
stress_scene(1200) through the port's RenderEngine and the JAX package's
with accel='pair' (JAX in interpret mode), in the megakernel and the
wavefront model, to the goldens' rtol 1e-4; `ptx-torch render --accel
pair`; and smooth shading refused for 'pair', 'cluster' and 'group' as
the JAX package refuses it (ValueError naming the accels that work)."""

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


@pytest.mark.parametrize("model", ["megakernel", "wavefront"])
def test_engine_render_matches_jax(model):
    jimg, pimg = render_both(jlib.stress_scene(1200),
                             library.stress_scene(1200), "pair", model)
    np.testing.assert_allclose(pimg, jimg, rtol=1e-4, atol=1e-6)
    assert pimg.mean() > 0.0


def test_cli_render_pair(tmp_path, capsys):
    out = tmp_path / "pair.png"
    rc = cli.main(["render", "--scene", "cornell", "--accel", "pair",
                   "--size", "16x16", "--spp", "1", "--device", "cpu",
                   "--out", str(out)])
    assert rc == 0 and out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "on cpu" in capsys.readouterr().err


@pytest.mark.parametrize("accel", ["pair", "cluster", "group"])
def test_smooth_refused_as_in_jax(accel):
    js = jlib.cornell_box(with_spheres=True, smooth_spheres=True)
    ps = library.cornell_box(with_spheres=True, smooth_spheres=True)
    with pytest.raises(ValueError) as jerr:
        jengine.make_intersect_fn(js, accel, smooth=True)
    with pytest.raises(ValueError) as perr:
        engine.make_intersect_fn(ps, accel, smooth=True)
    for err in (jerr, perr):
        msg = str(err.value)
        assert all(a in msg for a in ("minarg", "tilecull", "pairwin",
                                      "bruteforce")) and accel in msg
    assert engine.resolve_accel(accel, 99_380, True) == accel
    assert engine.resolve_accel("pairmx", 99_380, True) == "pairmx"
    # 'pairmx' reports no ids either: smooth shading refuses it as JAX's
    # engine does.
    with pytest.raises(ValueError) as perr:
        engine.make_intersect_fn(ps, "pairmx", smooth=True)
    assert "pairmx" in str(perr.value)
