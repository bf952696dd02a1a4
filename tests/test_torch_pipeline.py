"""The second slice as a whole: the port's fused fast pipeline (K13a,
K13b, the K4 exact slice and K5; plain versions on the CPU) against the
JAX package's (Pallas kernels in interpret mode) on the Cornell box at
32x32 with tr = 128, so 8 slices: the start state bit-equal, then 6 steps
each from the same input state, the hit rows (pending masks included)
bit-equal and the new state within K5's tolerances; render_fast's
sample bookkeeping; spheres refused."""

import jax
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.models import pipeline as jpipe
from opencl_path_tracer_tpu.ops.pallas import plucker_kernel as jpk
from opencl_path_tracer_tpu.ops.pallas.intersect_kernel import (
    _run as jdense, build_tri_pack as jbuild,
)
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import interop
from opencl_path_tracer_tpu_torch.models import fused_step as fs
from opencl_path_tracer_tpu_torch.models import pipeline
from opencl_path_tracer_tpu_torch.ops import rng
from opencl_path_tracer_tpu_torch.scene import library
from test_torch_fused_step import assert_packs_close

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

W = H = 32
TR = 128


def _jax_hit_rows(jplucker, jpack, F, ctr, n_slices, sl_len):
    """JAX's hit rows of one pipeline step (pipeline.py:99-128)."""
    rays8 = np.zeros((8, F.shape[1]), np.float32)
    rays8[0:6] = np.asarray(F)[3:9]
    rows = [np.array(r)[0] for r in jplucker.rows(rays8)]
    s = (ctr % n_slices) * sl_len
    d = [np.asarray(x) for x in jdense(
        rays8[:, s:s + sl_len], jpack, TR, min(1024, jpack.shape[0]), True,
        256)]
    rows[0][s:s + sl_len] = np.where(d[0] < 3.0e38, d[0], -1.0)
    for k in range(4):
        rows[1 + k][s:s + sl_len] = d[2 + k]
    rows[5][s:s + sl_len] = 0.0
    return np.stack(rows)


def test_pipeline_steps_match_jax():
    js = jlib.cornell_box(with_spheres=True)
    ps = library.cornell_box(with_spheres=True)
    jkey = jax.random.key(1)
    (jF, jI, jctr), jstep, _ = jpipe.make_fast_pipeline(
        js, jlib.cornell_camera(W, H), width=W, height=H, iterations=3,
        key=jkey, tr=TR, interpret=True)
    (F, I, ctr), step, unpack = pipeline.make_fast_pipeline(
        ps, library.cornell_camera(W, H), width=W, height=H, iterations=3,
        key=rng.key(1), tr=TR)
    np.testing.assert_array_equal(F.numpy(), np.asarray(jF))
    np.testing.assert_array_equal(I.numpy(), np.asarray(jI))
    assert ctr == int(jctr) and step.n_slices == 8
    jplucker = jpk.make_plucker_intersect(js.tris, tr=TR, interpret=True)
    jpack = jbuild(js.tris, 1024)
    pending = 0
    for s in range(6):
        F, I, ctr = interop.packed_from_numpy(jF, jI, jctr)
        h = step.hit_rows(F, ctr)
        jh = _jax_hit_rows(jplucker, jpack, jF, int(jctr), 8, W * H // 8)
        np.testing.assert_array_equal(h.numpy().view(np.int32),
                                      jh.view(np.int32), err_msg=f"step {s}")
        pending += int((h[5] > 0).sum())
        F2, I2, ctr2 = step(F, I, ctr)
        jF, jI, jctr = jstep(jF, jI, jctr)
        assert ctr2 == int(jctr)
        assert_packs_close(F2, I2, jF, jI, f"step {s}: ")
    st = unpack(F2, I2, ctr2)
    assert st.step == 7 and int(st.samples.sum()) > 0
    # Pending is the rare escape hatch: under 2 % of lane-steps here.
    assert pending < 6 * W * H // 50


def test_render_fast_bookkeeping_and_refusals():
    scene = library.cornell_box(with_spheres=False)
    cam = library.cornell_camera(16, 16)
    st, secs, timed = pipeline.render_fast(
        scene, cam, width=16, height=16, iterations=2, steps=4,
        key=rng.key(3), device="cpu")
    (F, I, ctr), step, unpack = pipeline.make_fast_pipeline(
        scene, cam, width=16, height=16, iterations=2, key=rng.key(3))
    for k in range(6):                         # 2 warm-up + 4 timed steps
        if k == 2:
            warm = int(unpack(F, I, ctr).samples.sum())
        F, I, ctr = step(F, I, ctr)
    ref = unpack(F, I, ctr)
    assert st.step == ref.step == 7 and secs > 0
    # The samples finished in the timed steps, counted, not scaled.
    assert timed == int(ref.samples.sum()) - warm
    assert 0 < timed <= 4 * st.lanes
    assert torch.equal(st.samples, ref.samples)
    assert all(torch.equal(a, b) for a, b in zip(st.colors, ref.colors))
    # A path of 2 bounces finishes a sample in 1 or 2 steps.
    assert int(st.samples.min()) >= 2 and int(st.samples.max()) <= 6
    assert np.isfinite(torch.stack(st.colors).numpy()).all()
    with pytest.raises(ValueError, match="triangles only"):
        pipeline.make_fast_pipeline(
            library.cornell_box(with_spheres=True, analytic_spheres=True),
            cam, width=16, height=16, iterations=2, key=rng.key(3))
    with pytest.raises(ValueError, match="neither CUDA nor the CPU"):
        pipeline.render_fast(scene, cam, width=16, height=16, iterations=2,
                             steps=1, key=rng.key(3), device="meta")
