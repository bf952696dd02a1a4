"""The stress scenes at the port's entry points, on the CPU: `ptx-torch
render --scene stress` and `stress-analytic` build the JAX package's
scenes (99,380 triangles; 20 triangles and 138 analytic spheres), 'auto'
sends a scene over 8,192 triangles (over 4,096 with smooth shading) to
'pairwin', whose hits equal the dense K4's; `stress-analytic --smooth`
is refused as in JAX's CLI; and a deeper pair schedule (cluster_size
64: 12 clusters, so both tier escalations and the capacity loop run)
stays bit-equal to JAX's."""

import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu_torch import cli
from opencl_path_tracer_tpu_torch.core.types import Rays
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.runtime import engine
from opencl_path_tracer_tpu_torch.scene import library
from test_torch_pair_intersect import (  # noqa: F401 (scenes: a fixture)
    _assert_hits_bit_equal, _run, scenes,
)

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)


def test_stress_scenes_have_the_jax_counts():
    """The counts of the JAX builders (library.py:325-406): the shell's
    20 triangles and 138 spheres of 720."""
    s = cli._build_scene("stress", "cpu")
    assert s.num_triangles == 99_380 and s.spheres is None
    a = cli._build_scene("stress-analytic", "cpu")
    assert a.num_triangles == 20 and a.spheres.count == 138
    with pytest.raises(SystemExit, match="smooth"):
        cli._build_scene("stress-analytic", "cpu", smooth=True)
    assert cli._camera_preset("stress", object()).fov == 60.0


@pytest.mark.parametrize("smooth", [False, True])
def test_auto_is_pairwin_above_the_cut(smooth):
    """stress_scene(9000) has 8,660 triangles: 'auto' builds the pair
    intersector (with ids and interpolation when smooth), whose hits
    equal K4's."""
    s = library.stress_scene(9000, smooth=smooth)
    assert s.num_triangles > engine.AUTO_MINARG_MAX_TRIS
    assert engine.resolve_accel("auto", s.num_triangles, False,
                                smooth) == "pairwin"
    fn = engine.make_intersect_fn(s, "auto", smooth=smooth)
    rs = np.random.default_rng(0)
    p = torch.from_numpy(rs.uniform(50, 950, (3, 64)).astype(np.float32))
    d = torch.from_numpy(rs.normal(size=(3, 64)).astype(np.float32))
    d /= d.norm(dim=0)
    rays = Rays(p=tuple(p), d=tuple(d))
    h = fn(rays)
    t, g, nx, *_ = k1.dense(k1.pack_rays(rays.p, rays.d),
                            k1.build_tri_pack(s.tris))
    assert torch.equal(h.t, torch.where(t < k1.BIG, t, -1.0))
    if not smooth:
        hit = t < k1.BIG
        assert torch.equal(h.n[0][hit], nx[hit])


def test_cli_renders_stress_analytic(tmp_path, capsys):
    out = tmp_path / "a.png"
    assert cli.main(["render", "--scene", "stress-analytic", "--size",
                     "16x12", "--spp", "1", "--device", "cpu", "--out",
                     str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "on cpu" in capsys.readouterr().err


def test_deeper_schedule_bit_equal(scenes):
    """cluster_size 64 (12 clusters): round 2, tier A (window 8), tier B
    and the capacity loop all run; ids too."""
    jout, pout, stats, _ = _run(scenes, "box", True, cluster_size=64)
    (jh, jids), (ph, pids) = jout, pout
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    _assert_hits_bit_equal(jh, ph)
    assert stats["isect.escalations"] >= 3
