"""K14 (K1's min + argmin and K2's attribute fetch in one launch) and
`make_minarg_intersect(fuse_fetch=True)` in the port against the JAX
package's `_minarg_fused_kernel` run in interpret mode.

Tolerance: none. `minarg_fused_plain` equals interpret-mode
`_run_minarg_fused` bit for bit on its five outputs (t, nx, ny, nz, m),
on random rays and on rays aimed at vertices and edges, with a triangle 0
whose normal has a -0.0 component; the intersector's Hits equal JAX's
bit for bit through K14, whether the JAX package's table is one tt block
(its K14) or more (its K1 + K2); a 16x16 Cornell render through K14 is
bit-equal to the port's K1 + K2 render.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.ops.pallas import intersect_kernel as jik
from opencl_path_tracer_tpu.ops.pallas import plucker_kernel as jk
from opencl_path_tracer_tpu_torch.models import megakernel
from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.ops.kernels import plucker_kernel as k2
from opencl_path_tracer_tpu_torch.scene import library

from test_torch_mxu_kernel import _bits, both_rays, rays, scene

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)


def jax_tabt(tri_pack):
    """The (64, Tpad) bf16 three-way split of the JAX package's
    `make_minarg_intersect` (plucker_kernel.py:544-553)."""
    t17 = np.asarray(tri_pack)[:, :17].T
    hi = np.asarray(jnp.asarray(t17).astype(jnp.bfloat16))
    mid = np.asarray(jnp.asarray(
        t17 - hi.astype(np.float32)).astype(jnp.bfloat16))
    lo = np.asarray(jnp.asarray(
        t17 - hi.astype(np.float32) - mid.astype(np.float32)
    ).astype(jnp.bfloat16))
    tabt = jnp.zeros((64, tri_pack.shape[0]), jnp.bfloat16)
    return tabt.at[0:17].set(hi).at[17:34].set(mid).at[34:51].set(lo)


@pytest.mark.parametrize("t", [300, 700])
def test_minarg_fused_plain_bit_equal_to_interpret_kernel(t):
    """300 triangles: one chunk of 512; 700: two, strict < between."""
    v, jt, pt = scene(t)
    p, d = rays(v)
    r = p.shape[0]
    j8 = jik.pack_rays(tuple(jnp.asarray(p[:, c]) for c in range(3)),
                       tuple(jnp.asarray(d[:, c]) for c in range(3)),
                       -(-r // 1024) * 1024)
    jpack = jik.build_tri_pack(jt, 1024)
    want = [np.asarray(o)[0, :r] for o in jk._run_minarg_fused(
        j8, jpack, jax_tabt(jpack), 1024, 512, True)]
    rays8 = torch.from_numpy(np.asarray(j8)[:, :r].copy())
    pack = k1.build_tri_pack(pt)
    got = k2.minarg_fused(rays8, pack)
    for what, a, b in zip(("t", "nx", "ny", "nz", "m"), got, want):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b),
                                      err_msg=what)
    # It is K1 then K2, and its t is K4's.
    for a, b in zip(got, k2.refine1(*k1.minarg(rays8, pack), pack)):
        assert torch.equal(a, b)
    t4 = k1.dense(rays8, pack)[0]
    assert torch.equal(got[0], torch.where(t4 < k1.BIG, t4,
                                           torch.full_like(t4, -1.0)))
    hit = want[0] > 0.0
    assert 0 < hit.sum() < r
    assert not (torch.signbit(got[1]) & (got[1] == 0.0)).any()


def _equal_hits(ph, jh):
    np.testing.assert_array_equal(_bits(ph.t.numpy()), _bits(jh.t))
    np.testing.assert_array_equal(ph.mati.numpy(), np.asarray(jh.mati))
    for c in range(3):
        np.testing.assert_array_equal(_bits(ph.n[c].numpy()), _bits(jh.n[c]))
        np.testing.assert_array_equal(_bits(ph.p[c].numpy()), _bits(jh.p[c]))


@pytest.mark.parametrize("tt", [1024, 304, 300, 256])
def test_fuse_fetch_intersector_hits_equal_jax(monkeypatch, tt):
    """T = 300: the JAX package pads it to a multiple of 8 (304 rows) when
    T <= tt, else to a multiple of tt, and runs K14 only on one block: for
    tt 1024 and 304, K1 + K2 for tt 300 (304 rows) and 256 (512 rows)
    (plucker_kernel.py:560). The port runs K14 at every tt, with the same
    Hits."""
    v, jt, pt = scene(300, seed=5)
    jr, pr = both_rays(*rays(v, 256, seed=6))
    jh = jk.make_minarg_intersect(jt, tr=1024, tt=tt, fuse_fetch=True,
                                  interpret=True)(jr)

    def must_not_run(*args):
        raise AssertionError("K1 ran")

    monkeypatch.setattr(k2, "minarg", must_not_run)
    ph = k2.make_minarg_intersect(pt, fuse_fetch=True)(pr)
    _equal_hits(ph, jh)
    assert (ph.t.numpy() == -1.0).any() and (ph.t.numpy() > 0.0).any()


def test_fuse_fetch_with_ids_raises():
    _, jt, pt = scene(60)
    with pytest.raises(ValueError, match="with_ids needs fuse_fetch=False"):
        k2.make_minarg_intersect(pt, fuse_fetch=True, with_ids=True)
    with pytest.raises(ValueError, match="with_ids needs fuse_fetch=False"):
        jk.make_minarg_intersect(jt, fuse_fetch=True, with_ids=True)


def test_fused_render_bit_equal_to_minarg_render():
    scene_ = library.cornell_box(with_spheres=True)
    cam = library.cornell_camera(16, 16)
    states = [megakernel.render(
        cam, scene_.mats,
        intersect_fn=k2.make_minarg_intersect(scene_.tris, fuse_fetch=fuse),
        num_pixels=256, iterations=4, spp=2, mode="parity", device="cpu")
        for fuse in (True, False)]
    a, b = (megakernel.colors_array(s) for s in states)
    assert torch.isfinite(a).all() and a.max() > 0.0
    assert torch.equal(a, b)
    assert torch.equal(states[0].rng_state, states[1].rng_state)


def test_minarg_fused_wrapper_checks_and_cpu_counts_no_launch():
    _, _, pt = scene(60)
    pack = k1.build_tri_pack(pt)
    before = dict(_build.launches)
    t, nx, ny, nz, m = k2.minarg_fused(torch.zeros((8, 10)), pack)
    assert _build.launches == before
    assert (t == -1.0).all() and (m == float(pt.mati[0])).all()
    with pytest.raises(ValueError):
        k2.minarg_fused(torch.zeros((6, 10)), pack)
    with pytest.raises(TypeError):
        k2.minarg_fused(torch.zeros((8, 10), dtype=torch.float64), pack)
    with pytest.raises(ValueError):
        k2.minarg_fused(torch.zeros((8, 10)), pack[:0])
    with pytest.raises(ValueError):
        k2.minarg_fused(torch.zeros((8, 10)), pack[:, :16].contiguous())
