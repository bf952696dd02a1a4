"""K20 (the lazy march) and the lazy-certification wavefront in the port
against the JAX package on the CPU: K20's plain version equals
interpret-mode `run_lazy_march` (seven rows and the visited mask), also
across a mask-word boundary from the dense net's carried rows, and
`unvisited_mask` JAX's; K20's check-only entries refuse CPU tensors; three lazy steps from the JAX state equal JAX's
step, both modes, leaf for leaf through `interop` (the search carry, the
mask, the counters and the integer fields bit for bit; the shading's
floats to the wavefront tests' rtol 2e-5, atol 2e-6, as the port's eager
wavefront meets JAX's); in parity mode the port's lazy colors per pixel
equal its eager wavefront's at equal spp, the contract of
tests/test_lazy.py; and the pipeline runs on CUDA unless asked for the
CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.models import lazy as jlazy
from opencl_path_tracer_tpu.ops.pallas import lazy_march as jlm
from opencl_path_tracer_tpu.ops.pallas import march_kernel as jmk
from opencl_path_tracer_tpu.ops.pallas.plucker_kernel import (
    plucker_feat as jfeat,
)
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import interop
from opencl_path_tracer_tpu_torch.models import lazy, wavefront
from opencl_path_tracer_tpu_torch.ops import rng
from opencl_path_tracer_tpu_torch.ops.kernels import lazy_march as lm
from opencl_path_tracer_tpu_torch.ops.kernels import march_kernel as mk
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import BIG
from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
    plucker_feat,
)
from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
from opencl_path_tracer_tpu_torch.scene import library
from test_torch_march_kernel import aimed_rays, bits

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

CS = TR = 128
W = H = 16
RTOL, ATOL = 2e-5, 2e-6   # tests/test_torch_wavefront.py's
SEARCH = ("mt", "mnx", "mny", "mnz", "mm", "mg", "vis", "completions",
          "samples", "pixel", "rng_state", "inside", "bounce", "step")


def test_k20_and_unvisited_mask_equal_interpret_mode():
    jsc, _, c = jmk.build_march_scene(jlib.stress_scene(1200).tris, CS)
    psc, _, _ = mk.build_march_scene(library.stress_scene(1200).tris, CS)
    r8 = aimed_rays(512, 21, jlib.stress_scene(1200).tris)
    pr8 = torch.as_tensor(r8)
    feat = plucker_feat(pr8)
    ent, need = mk._slab_entries(pr8, psc, torch.full((512,), BIG))
    cl = mk._block_lists(ent, need, TR, 1)
    rows = mk.run_march(cl, pr8, feat, psc, CS, 1, TR)[:6].contiguous()
    rows[:, ::5] = torch.tensor([BIG, 0, 0, 0, 0, 0])[:, None]
    cw = -(-c // 32)
    rs = np.random.default_rng(4)
    vis_u = (rs.integers(0, 1 << 32, (cw, 512), dtype=np.uint64)
             & rs.integers(0, 1 << 32, (cw, 512), dtype=np.uint64)
             ).astype(np.uint32)
    vis_u[:, ::2] = 0
    vis = torch.as_tensor(vis_u.view(np.int32))
    cl3 = mk._block_lists(ent, mk._need(ent, rows[0]) & lm.unvisited_mask(
        vis, c), TR, 3)
    got, gvis = lm.run_lazy_march(cl3, pr8, feat, rows, vis, psc, CS, 3, TR)
    want, wvis = jlm.run_lazy_march(
        jnp.asarray(cl3.numpy()), jnp.asarray(r8), jfeat(jnp.asarray(r8)),
        tuple(jnp.asarray(rows[k:k + 1].numpy()) for k in range(6)),
        jnp.asarray(vis_u), jsc, CS, 3, TR, True)
    for k in range(7):
        np.testing.assert_array_equal(bits(got[k]), bits(want[k][0]),
                                      err_msg=f"row {k}")
    np.testing.assert_array_equal(gvis.numpy().view(np.uint32),
                                  np.asarray(wvis))
    assert bool((gvis != vis).any()) and int(got[6].sum()) >= 0
    np.testing.assert_array_equal(
        lm.unvisited_mask(gvis, c).numpy(),
        np.asarray(jlm.unvisited_mask(wvis, c)))


def test_k20_at_a_mask_word_boundary_with_dense_net_rows():
    """K20's plain version equals interpret-mode `run_lazy_march` with two
    mask words (46 clusters of 64: bits set on both sides of the word
    boundary) and carried rows as the dense net writes them (every third
    lane K4's hit with g = 0): where a visit finds that same hit it only
    ties (t, g) = (t, 0), so the lane keeps g = 0 and K4's attributes."""
    from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
    cs = 64
    jsc, _, c = jmk.build_march_scene(jlib.stress_scene(3000).tris, cs)
    psc, rt, _ = mk.build_march_scene(library.stress_scene(3000).tris, cs)
    cw = -(-c // 32)
    assert cw == 2
    r8 = aimed_rays(512, 22, jlib.stress_scene(3000).tris)
    pr8 = torch.as_tensor(r8)
    feat = plucker_feat(pr8)
    ent, need = mk._slab_entries(pr8, psc, torch.full((512,), BIG))
    rows = mk.run_march(mk._block_lists(ent, need, TR, 1), pr8, feat, psc,
                        cs, 1, TR)[:6].clone()
    t4, _, nx, ny, nz, m = k1.dense(pr8, k1.build_tri_pack(rt))
    net = torch.stack([torch.where(t4 < BIG, t4, BIG), nx, ny, nz, m,
                       torch.zeros_like(t4)])
    rows[:, ::3] = net[:, ::3]
    rs = np.random.default_rng(8)
    vis_u = (rs.integers(0, 1 << 32, (cw, 512), dtype=np.uint64)
             & rs.integers(0, 1 << 32, (cw, 512), dtype=np.uint64)
             & rs.integers(0, 1 << 32, (cw, 512), dtype=np.uint64)
             ).astype(np.uint32)
    vis = torch.as_tensor(vis_u.view(np.int32))
    cl = mk._block_lists(ent, mk._need(ent, rows[0]) & lm.unvisited_mask(
        vis, c), TR, 6)
    got, gvis = lm.run_lazy_march(cl, pr8, feat, rows, vis, psc, cs, 6, TR)
    want, wvis = jlm.run_lazy_march(
        jnp.asarray(cl.numpy()), jnp.asarray(r8), jfeat(jnp.asarray(r8)),
        tuple(jnp.asarray(rows[k:k + 1].numpy()) for k in range(6)),
        jnp.asarray(vis_u), jsc, cs, 6, TR, True)
    for k in range(7):
        np.testing.assert_array_equal(bits(got[k]), bits(want[k][0]),
                                      err_msg=f"row {k}")
    np.testing.assert_array_equal(gvis.numpy().view(np.uint32),
                                  np.asarray(wvis))
    # Both mask words gained bits.
    gained = (gvis != vis).any(dim=1)
    assert bool(gained.all())
    # The lanes whose visits found K4's hit again: from a miss they reach
    # t4; from the dense net's row they tie and keep it.
    fresh, _ = lm.run_lazy_march(cl, pr8, feat,
                                 mk.miss_rows(512, "cpu")[:6].contiguous(),
                                 vis, psc, cs, 6, TR)
    tie = torch.zeros(512, dtype=torch.bool)
    tie[::3] = True
    tie &= (fresh[0] == t4) & (t4 < BIG)
    assert int(tie.sum()) > 5
    assert torch.equal(got[:6, tie], rows[:, tie])


def test_k20_check_entries_run_on_cuda_only():
    """K20's first kernel and its counting entry take CUDA tensors only:
    on the CPU they raise, where run_lazy_march takes the plain version."""
    psc, _, c = mk.build_march_scene(library.stress_scene(1200).tris, CS)
    pr8 = torch.as_tensor(aimed_rays(128, 5, jlib.stress_scene(1200).tris))
    args = (torch.zeros(1, dtype=torch.int32), pr8, plucker_feat(pr8),
            mk.miss_rows(128, "cpu")[:6].contiguous(),
            torch.zeros((-(-c // 32), 128), dtype=torch.int32), psc, CS, 1,
            TR)
    out, vis = lm.run_lazy_march(*args)
    assert out.shape == (7, 128) and vis.shape == args[4].shape
    for fn in (lm.run_lazy_march_simt, lm.run_lazy_march_counted):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fn(*args)


def _jax_fields(jst):
    return {f: jax.tree.map(np.asarray, getattr(jst, f))
            for f in jst.__dataclass_fields__}


@pytest.mark.parametrize("mode", ["fast", "parity"])
def test_three_steps_equal_jax(mode):
    js, ps = (jlib.cornell_box(with_spheres=True),
              library.cornell_box(with_spheres=True))
    jcam, pcam = jlib.cornell_camera(W, H), library.cornell_camera(W, H)
    jstep, jinit, _ = jlazy.make_lazy_pipeline(js.tris, cs=CS, tr=TR, K=2,
                                               tail=128, interpret=True)
    pstep, pinit, _ = lazy.make_lazy_pipeline(ps.tris, cs=CS, tr=TR, K=2,
                                              tail=128, device="cpu")
    jkey = jax.random.key(7) if mode == "fast" else None
    pkey = rng.key(7) if mode == "fast" else None
    jst = jinit(jcam, W * H, mode=mode, key=jkey)
    pst = pinit(pcam, W * H, mode=mode, key=pkey)
    first = interop.lazy_state_to_numpy(pst)
    for name, v in _jax_fields(jst).items():
        if name not in ("ray_d", "f_l"):
            np.testing.assert_equal(first[name], v, err_msg=f"init {name}")
    for s in range(3):
        start = _jax_fields(jst)
        port_start = interop.lazy_state_from_numpy(start)
        np.testing.assert_equal(interop.lazy_state_to_numpy(port_start),
                                start)
        got = interop.lazy_state_to_numpy(pstep(
            pcam, ps.mats, port_start, iterations=3, mode=mode, key=pkey))
        jst = jstep(jcam, js.mats, jst, iterations=3, mode=mode, key=jkey)
        want = _jax_fields(jst)
        for name in want:
            if name in SEARCH:
                np.testing.assert_equal(got[name], want[name],
                                        err_msg=f"step {s}: {name}")
            else:
                for k in range(3):
                    np.testing.assert_allclose(got[name][k], want[name][k],
                                               rtol=RTOL, atol=ATOL,
                                               err_msg=f"step {s}: {name}")
        assert 0 < int(got["completions"]) <= (s + 1) * W * H


def test_parity_colors_equal_eager_wavefront():
    scene = library.cornell_box(with_spheres=True)
    cam = library.cornell_camera(W, H)
    n = W * H
    ref = wavefront.render_wavefront(
        cam, scene.mats, intersect_fn=make_intersect_fn(scene, "minarg"),
        num_pixels=n, iterations=3, min_spp=2, mode="parity", exact_spp=True,
        device="cpu")
    step, init, _ = lazy.make_lazy_pipeline(scene.tris, cs=256, tr=128, K=2,
                                            tail=128, device="cpu")
    st = init(cam, n, mode="parity")
    for _ in range(200):
        st = step(cam, scene.mats, st, iterations=3, mode="parity",
                  max_samples=2)
        if int(st.samples.min()) >= 2:
            break
    assert int(st.samples.min()) == 2 == int(st.samples.max())
    # Lazy lanes are re-sorted every step: compare per pixel.
    assert torch.equal(wavefront.colors_by_pixel(st, n),
                       wavefront.colors_by_pixel(ref, n))
    assert int(st.completions) > 2 * n


def test_pipeline_runs_on_cuda_unless_asked(monkeypatch):
    tris = library.cornell_box(with_spheres=True).tris
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lazy.make_lazy_pipeline(tris)
    step, init, rt = lazy.make_lazy_pipeline(tris, cs=256, tr=128,
                                             device="cpu")
    st = init(library.cornell_camera(W, H), W * H, mode="fast",
              key=rng.key(1))
    assert st.vis.shape == (1, W * H) and st.vis.dtype == torch.int32
    assert {f.name for f in dataclasses.fields(lazy.LazyState)} == set(
        jlazy.LazyState.__dataclass_fields__)
    assert rt.count == tris.count
