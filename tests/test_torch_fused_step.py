"""K5 (the fused fast-mode wavefront step) in the port against the JAX
package's Pallas kernel run in interpret mode, per step from the same
packed state and hit rows, with the tolerances of tests/test_fused_step.py
(integers exact; floats rtol 1e-6, atol 1e-6, and atol 1e-3 for ray_p and
cur_color: XLA contracts multiply-adds in interpret mode, the port rounds
each operation); the pending-lane freeze; and pack/unpack against JAX's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.models import fused_step as jfs
from opencl_path_tracer_tpu.models import wavefront as jwf
from opencl_path_tracer_tpu.ops import intersect as jisect
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import interop
from opencl_path_tracer_tpu_torch.core.types import Hits
from opencl_path_tracer_tpu_torch.models import fused_step as fs
from opencl_path_tracer_tpu_torch.ops import rng
from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

W = H = 32
ROWS = {"colors": 0, "ray_p": 3, "ray_d": 6, "f_l": 9, "f_b": 12, "f_s": 15,
        "f_r": 18, "cur_color": 21}
I_ROWS = {"samples": 0, "pixel": 1, "inside": 3, "bounce": 4}


def assert_packs_close(F, I, jF, jI, what=""):
    """K5's tolerances on every state row of (F, I) against JAX's."""
    F, I = F.cpu().numpy(), I.cpu().numpy()
    jF, jI = np.asarray(jF), np.asarray(jI)
    for name, r in ROWS.items():
        atol = 1e-3 if name in ("ray_p", "cur_color") else 1e-6
        for k in range(3):
            x, y = F[r + k], jF[r + k]
            nan = np.isnan(x) & np.isnan(y)
            np.testing.assert_allclose(np.where(nan, 0, x), np.where(nan, 0, y),
                                       rtol=1e-6, atol=atol,
                                       err_msg=f"{what}{name}[{k}]")
    np.testing.assert_array_equal(F[24:], jF[24:], err_msg=f"{what}rows 24+")
    for name, r in I_ROWS.items():
        np.testing.assert_array_equal(I[r], jI[r], err_msg=f"{what}{name}")


def _setup(iters, seed):
    js = jlib.cornell_box(with_spheres=True)
    jcam = jlib.cornell_camera(W, H)
    ps = library.cornell_box(with_spheres=True)
    pcam = library.cornell_camera(W, H)
    jstep = jfs.make_fused_step(jcam, js.mats, width=W, height=H,
                                iterations=iters, key=jax.random.key(seed),
                                tr=1024, interpret=True)
    pstep = fs.make_fused_step(pcam, ps.mats, width=W, height=H,
                               iterations=iters, key=rng.key(seed))
    isect = functools.partial(jisect.first_intersect, tris=js.tris)
    return js, jcam, jstep, pstep, isect


@pytest.mark.parametrize("iters", [1, 3])
def test_step_matches_interpret_kernel_per_step(iters):
    js, jcam, jstep, pstep, isect = _setup(iters, 7)
    key = jax.random.key(7)
    ref = jwf.init_wavefront(jcam, W * H, mode="fast", key=key)
    for s in range(4):
        jF, jI, ctr = jfs.pack_state(ref, W, H)
        # The port packs the same state bit for bit.
        pst = interop.wavefront_state_from_numpy(
            {f: getattr(ref, f) for f in ref.__dataclass_fields__})
        F, I, pctr = fs.pack_state(pst, W, H)
        np.testing.assert_array_equal(F.numpy(), np.asarray(jF))
        np.testing.assert_array_equal(I.numpy(), np.asarray(jI))
        assert pctr == int(ctr)
        jH = jfs.hits_to_pack(isect(jwf.Rays(p=ref.ray_p, d=ref.ray_d)))
        jF2, jI2 = jstep(jF, jI, ctr, jH)
        F2, I2 = pstep(F, I, pctr, torch.from_numpy(np.array(jH)))
        assert_packs_close(F2, I2, jF2, jI2, f"step {s}: ")
        ref = jwf.wavefront_step(jcam, js.mats, ref, intersect_fn=isect,
                                 iterations=iters, mode="fast", key=key)
    got = fs.unpack_state(F2, I2, pctr + 1)
    assert got.step == int(ref.step)
    assert int(got.samples.sum()) > 0


def test_pending_lanes_freeze():
    js, jcam, jstep, pstep, isect = _setup(3, 3)
    st = jwf.init_wavefront(jcam, W * H, mode="fast",
                            key=jax.random.key(3))
    jF, jI, ctr = jfs.pack_state(st, W, H)
    hits = isect(jwf.Rays(p=st.ray_p, d=st.ray_d))
    jH = jfs.hits_to_pack(hits, pending=jnp.zeros((W * H,), bool)
                          .at[:100].set(True))
    F, I, step = interop.packed_from_numpy(jF, jI, ctr)
    hr = torch.from_numpy(np.array(jH))
    F2, I2 = pstep(F, I, step, hr)
    jF2, jI2 = jstep(jF, jI, ctr, jH)
    assert_packs_close(F2, I2, jF2, jI2)
    nF, nI, nstep = interop.packed_to_numpy(F2, I2, step + 1)
    assert nF.dtype == np.float32 and nI.dtype == np.int32 and nstep == 2
    # Frozen: ray, factors, color, bounce and samples unchanged.
    assert torch.equal(F2[:, :100], F[:, :100])
    assert torch.equal(I2[:, :100], I[:, :100])
    assert (I2[4, 100:] != 0).any() or (I2[0, 100:] != 0).any()
    # hits_to_pack of the port gives JAX's rows.
    ph = fs.hits_to_pack(Hits(t=hr[0], p=(hr[0],) * 3, n=(hr[1], hr[2], hr[3]),
                              mati=hr[4].to(torch.int32)), hr[5] > 0)
    assert torch.equal(ph, hr)


def test_wrapper_checks_and_cpu_counts_no_launch():
    _, _, _, pstep, _ = _setup(3, 1)
    F = torch.zeros((32, 16))
    I = torch.zeros((8, 16), dtype=torch.int32)
    Hr = torch.zeros((6, 16))
    before = dict(_build.launches)
    F2, I2 = pstep(F, I, 1, Hr)                  # a (6, N) H is enough
    assert _build.launches == before and F2.shape == F.shape
    with pytest.raises(TypeError):
        pstep(F, I.float(), 1, Hr)
    with pytest.raises(ValueError):
        pstep(F, I, 1, torch.zeros((5, 16)))
    with pytest.raises(ValueError):
        pstep(F[:, :8], I, 1, Hr)
