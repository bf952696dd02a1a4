"""K18 (the block march) and K18m (its operand copy) in the port against
the JAX package on the CPU, on stress_scene(1200) with clusters and
blocks of 128: `_slab_entries`, `_block_lists` and `_visited_from` equal
JAX's; K18's plain version equals interpret-mode `_run_march` in all
seven rows (t, nx, ny, nz, mati, g, pend), K18m's plain version
`_pallas_materialize`; `make_march_intersect`'s hits and its debug values
(round 1's resolved lanes and pend, round 2's lanes, uncertified and
pending flags, the lanes resolved before the tail, but for lanes round 1
left pending, which the port keeps for the tail) equal JAX's with a
small K1, so that round 2 and the dense tail run; the hits equal K4's
over the reordered triangles; rays that miss everything miss, as in
tests/test_march.py, and so do padded lanes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.core.types import Rays as JRays
from opencl_path_tracer_tpu.ops.pallas import march_kernel as jmk
from opencl_path_tracer_tpu.ops.pallas.plucker_kernel import (
    plucker_feat as jfeat,
)
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.core.types import Rays
from opencl_path_tracer_tpu_torch.ops.kernels import march_kernel as mk
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    BIG, make_pallas_intersect,
)
from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
    plucker_feat,
)
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

CS = TR = 128


@pytest.fixture(scope="module")
def scenes():
    """(JAX march scene, port march scene, C) of stress_scene(1200)."""
    jsc, _, c = jmk.build_march_scene(jlib.stress_scene(1200).tris, CS)
    psc, _, pc = mk.build_march_scene(library.stress_scene(1200).tris, CS)
    assert pc == c
    return jsc, psc, c


def aimed_rays(n, seed, scene_tris):
    """(8, n) float32 rays from inside the stress box, most aimed at a
    triangle corner (jittered), every seventh in a random direction."""
    rs = np.random.default_rng(seed)
    p = np.stack([rs.uniform(-90, 1090, n), rs.uniform(10, 990, n),
                  rs.uniform(-990, 990, n)], 1).astype(np.float32)
    corners = np.asarray(scene_tris.r1)
    d = corners[rs.integers(0, corners.shape[0], n)] + rs.normal(
        size=(n, 3)) - p
    d[::7] = rs.normal(size=d[::7].shape)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    r8 = np.zeros((8, n), np.float32)
    r8[0:3], r8[3:6] = p.T, d.T
    return r8


def to_rays(r8):
    """(JAX Rays, port Rays) of an (8, n) numpy pack."""
    return (JRays(p=tuple(jnp.asarray(r8[k]) for k in range(3)),
                  d=tuple(jnp.asarray(r8[k]) for k in range(3, 6))),
            Rays(p=tuple(torch.as_tensor(r8[k].copy()) for k in range(3)),
                 d=tuple(torch.as_tensor(r8[k].copy()) for k in range(3, 6))))


def bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def test_scene_sort_constants_equal_jax(scenes):
    jsc, psc, _ = scenes
    for f in ("scene_lo", "scene_inv"):
        np.testing.assert_array_equal(bits(getattr(psc, f)),
                                      bits(getattr(jsc, f)), err_msg=f)


@pytest.mark.parametrize("K", [2, 6, 9])
def test_slab_lists_and_visited_equal_jax(scenes, K):
    jsc, psc, c = scenes
    r8 = aimed_rays(512, K, jlib.stress_scene(1200).tris)
    best = np.full(512, BIG, np.float32)
    best[::3] = np.random.default_rng(K).uniform(0, 800, 171)
    jent, jneed = jmk._slab_entries(jnp.asarray(r8), jsc, jnp.asarray(best))
    ent, need = mk._slab_entries(torch.as_tensor(r8), psc,
                                 torch.as_tensor(best))
    np.testing.assert_array_equal(bits(ent), bits(jent))
    np.testing.assert_array_equal(need.numpy(), np.asarray(jneed))
    assert torch.equal(mk._need(ent, torch.as_tensor(best)), need)
    jcl = jmk._block_lists(jent, jneed, TR, K)
    cl = mk._block_lists(ent, need, TR, K)
    np.testing.assert_array_equal(cl.numpy(), np.asarray(jcl))
    if K > c:   # lists past C clusters are padded with dummies
        assert bool((cl.view(-1, K)[:, c:] == -1).all())
    np.testing.assert_array_equal(mk._visited_from(cl, c, K).numpy(),
                                  np.asarray(jmk._visited_from(jcl, c, K)))


@pytest.mark.parametrize("K", [3, 8])
def test_k18_and_k18m_equal_interpret_mode(scenes, K):
    jsc, psc, c = scenes
    r8 = aimed_rays(512, 10 + K, jlib.stress_scene(1200).tris)
    r8[:, 500:] = 0.0   # zero rays, as padding lanes are
    ent, need = mk._slab_entries(torch.as_tensor(r8), psc,
                                 torch.full((512,), BIG))
    cl = mk._block_lists(ent, need, TR, K)
    feat = plucker_feat(torch.as_tensor(r8))
    jf = jfeat(jnp.asarray(r8))
    np.testing.assert_array_equal(feat.view(torch.int16).numpy(),
                                  np.asarray(jf).view(np.int16))
    got = mk.run_march(cl, torch.as_tensor(r8), feat, psc, CS, K, TR)
    want = jmk._run_march(jnp.asarray(cl.numpy()), jnp.asarray(r8), jf, jsc,
                          CS, K, TR, True)
    for k in range(7):
        np.testing.assert_array_equal(bits(got[k]), bits(want[k][0]),
                                      err_msg=f"row {k}")
    assert int((got[0] < BIG).sum()) > 300
    assert not bool((got[0, 500:] < BIG).any())
    copies = mk.materialize(cl, torch.as_tensor(r8), feat)
    jcopies = jmk._pallas_materialize(jnp.asarray(cl.numpy()),
                                      jnp.asarray(r8), jf, TR, True)
    np.testing.assert_array_equal(copies[0].numpy(), np.asarray(jcopies[0])[0])
    np.testing.assert_array_equal(bits(copies[1]), bits(jcopies[1]))
    np.testing.assert_array_equal(copies[2].view(torch.int16).numpy(),
                                  np.asarray(jcopies[2]).view(np.int16))


def test_march_intersect_and_debug_equal_jax():
    js, ps = jlib.stress_scene(1200), library.stress_scene(1200)
    r8 = aimed_rays(300, 5, js.tris)   # 384 lanes, 84 of them padding
    jr, pr = to_rays(r8)
    ji, _ = jmk.make_march_intersect(js.tris, cs=CS, tr=TR, K1=2, K2=4,
                                     tail=128, interpret=True, debug=True)
    pi, prt = mk.make_march_intersect(ps.tris, cs=CS, tr=TR, K1=2, K2=4,
                                      tail=128, debug=True)
    jh, jd = ji(jr)
    ph, pd = pi(pr)
    np.testing.assert_array_equal(bits(ph.t), bits(jh.t))
    np.testing.assert_array_equal(ph.mati.numpy(), np.asarray(jh.mati))
    for k in range(3):
        np.testing.assert_array_equal(bits(ph.n[k]), bits(jh.n[k]))
        np.testing.assert_array_equal(bits(ph.p[k]), bits(jh.p[k]))
    for name in ("res1", "pend1", "idx2", "unc2", "pend2",
                 "best_pre_tail_t", "best_sorted_t", "order_l"):
        np.testing.assert_array_equal(bits(pd[name]), bits(jd[name]),
                                      err_msg=name)
    # The port keeps lanes round 1 left pending for the tail; the JAX
    # package lets round 2 resolve them (ROADMAP.md queue 3).
    np.testing.assert_array_equal(
        pd["res_pre_tail"].numpy(),
        np.asarray(jd["res_pre_tail"]) & ~np.asarray(jd["pend1"]))
    # Round 2 and the tail both had work.
    assert not bool(pd["res1"].all()) and not bool(pd["res_pre_tail"].all())
    ref = make_pallas_intersect(prt)(pr)
    assert torch.equal(ph.t, ref.t) and torch.equal(ph.mati, ref.mati)
    assert int((ph.t > 0).sum()) > 250


def test_all_miss_rays_miss():
    tris = library.stress_scene(1200).tris
    p = np.zeros((8, 256), np.float32)
    p[0:3] = 5000.0
    p[4] = 1.0
    _, pr = to_rays(p)
    isect, _ = mk.make_march_intersect(tris, cs=CS, tr=TR, K1=2, K2=4,
                                       tail=128)
    assert bool((isect(pr).t == -1.0).all())
