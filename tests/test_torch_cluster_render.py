"""The sixth slice's 'cluster' (K17) and 'group' (K16) accels as a whole
on the CPU: 16x16 renders of the Cornell box through the port's
RenderEngine and the JAX package's with the same accel (JAX in interpret
mode, the port with its plain versions), in the megakernel and the
wavefront model (2 bounces, 2 spp, fast mode), to the goldens' rtol
1e-4; and `ptx-torch render --accel cluster|group`."""

import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.config import CameraConfig as JCam
from opencl_path_tracer_tpu.config import RenderConfig as JCfg
from opencl_path_tracer_tpu.runtime.engine import RenderEngine as JEngine
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import cli
from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

CAM = dict(fov=60.0, yaw=0.0, pitch=0.0, shift=(0.0, 0.0, 0.0))


def render_both(jscene, pscene, accel, model, size=16):
    """The JAX engine's and the port's images (no tonemap) at size^2, 2
    bounces, 2 spp."""
    kw = dict(width=size, height=size, iterations=2, spp=2, mode="fast",
              accel=accel, model=model)
    je = JEngine(jscene, JCfg(camera=JCam(**CAM), **kw))
    je.render(2, progress=False)
    pe = RenderEngine(pscene, RenderConfig(camera=CameraConfig(**CAM), **kw),
                      device="cpu")
    pe.render(2)
    return je.image(apply_tonemap=False), pe.image(apply_tonemap=False)


@pytest.mark.parametrize("model", ["megakernel", "wavefront"])
@pytest.mark.parametrize("accel", ["cluster", "group"])
def test_engine_render_matches_jax(accel, model):
    jimg, pimg = render_both(jlib.cornell_box(with_spheres=True),
                             library.cornell_box(with_spheres=True), accel,
                             model)
    np.testing.assert_allclose(pimg, jimg, rtol=1e-4, atol=1e-6)
    assert pimg.shape == (16, 16, 3) and pimg.mean() > 0.0


@pytest.mark.parametrize("accel", ["cluster", "group"])
def test_cli_render(accel, tmp_path, capsys):
    out = tmp_path / f"{accel}.png"
    rc = cli.main(["render", "--scene", "cornell", "--accel", accel,
                   "--size", "16x16", "--spp", "1", "--device", "cpu",
                   "--out", str(out)])
    assert rc == 0 and out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "on cpu" in capsys.readouterr().err
