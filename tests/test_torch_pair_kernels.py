"""K9 (cluster candidates), K10 (pair visits) and K11 (winner attribute
fetch) in the port against the JAX package's Pallas kernels run in
interpret mode, on the same inputs, bit for bit: K9's ids and entries at
l = 2, 6 and 48 with and without the DOP columns; K10's t and
g * 2 + pend on cluster-sorted pairs (tiles of 128 with several runs
each, one spanning three clusters, and pending pairs); K11's rows,
g < 0 included. Also the visit lists, the pair sort (the JAX package's
`lax.sort` keeps slot order within a run on the CPU, as the port's
stable sort does) and a whole pairs round."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.ops.pallas import pair_mxu as jpm
from opencl_path_tracer_tpu.ops.pallas import sorted_intersect as jsi
from opencl_path_tracer_tpu.ops.pallas.march_kernel import (
    build_march_scene as jbuild,
)
from opencl_path_tracer_tpu.ops.pallas.plucker_kernel import (
    plucker_feat as jfeat,
)
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.ops.kernels import pair_mxu as pm
from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
from opencl_path_tracer_tpu_torch.ops.kernels.march_kernel import (
    build_march_scene,
)
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

N_TRIS, CS, TRP = 6000, 128, 128


@pytest.fixture(scope="module")
def scenes():
    """(JAX march scene, JAX reordered tris, port march scene, port
    reordered tris, C, boxes (Cp, 16) numpy) of stress_scene(6000)."""
    _, jrest = jsi.split_by_size(jlib.stress_scene(N_TRIS).tris)
    _, prest = si.split_by_size(library.stress_scene(N_TRIS).tris)
    jm, jrt, c = jbuild(jrest, CS)
    pmsc, prt, pc = build_march_scene(prest, CS)
    assert pc == c
    boxes = torch.cat([pmsc.boxes_lo, pmsc.boxes_hi, torch.zeros((c, 2)),
                       pm.build_dops(prt, CS, c)], 1)
    cp = -(-c // 128) * 128
    boxes_r = np.zeros((cp, 16), np.float32)
    boxes_r[:c] = boxes.numpy()
    return jm, jrt, pmsc, prt, c, boxes_r


def _rays(n, seed, aim=None):
    """(8, n) float32 rays from inside the box; with `aim` ((k, 3)
    points), each ray is aimed at one of them (jittered by 1e-3)."""
    rs = np.random.default_rng(seed)
    p = np.stack([rs.uniform(-90, 1090, n), rs.uniform(10, 990, n),
                  rs.uniform(-990, 990, n)], 1).astype(np.float32)
    if aim is None:
        d = rs.normal(size=(n, 3))
    else:
        d = (aim[rs.integers(0, aim.shape[0], n)]
             + rs.normal(size=(n, 3)) * 1e-3 - p)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    r8 = np.zeros((8, n), np.float32)
    r8[0:3], r8[3:6] = p.T, d.T
    return r8


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


@pytest.mark.parametrize("l", [2, 6, 48])
@pytest.mark.parametrize("dop", [False, True])
def test_k9_candidates_bit_equal(scenes, l, dop):
    *_, c, boxes_r = scenes
    boxw = 16 if dop else 8
    b = np.ascontiguousarray(boxes_r[:, :boxw])
    r8 = np.concatenate([_rays(192, 1), _rays(64, 2, aim=b[:c, 0:3])], 1)
    # Axis-parallel and zero-direction rays: the d == 0 containment branch.
    r8[3:6, :8] = 0.0
    r8[3, 4:8] = 1.0
    jids, jent, jnxt = jsi._run_candidates(jnp.asarray(r8), jnp.asarray(b),
                                           l, c, 128, True)
    ids, ent, nxt = si.run_candidates(torch.from_numpy(r8),
                                      torch.from_numpy(b), l, c)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(_bits(ent), _bits(jent))
    np.testing.assert_array_equal(_bits(nxt), _bits(jnxt))
    assert (ids.numpy() < c).any() and (ids.numpy() == c).any()


def _sorted_pairs(prt, c, cs, trp, seed):
    """Cluster-sorted pairs: every cluster's run 0 to 60 trp / 128 pairs
    long, the runs cut so that tile 2 holds exactly three clusters (40,
    50 and 38 trp / 128 pairs), then dummy keys to a whole tile and half
    a tile more; the rays aimed at the vertices and edge midpoints of
    their key cluster's triangles (the eps band of the conservative test,
    where pairs end pending)."""
    rs = np.random.default_rng(seed)
    f = trp // 128
    lengths = rs.integers(0, 60 * f + 1, c)
    k = int(np.searchsorted(np.cumsum(lengths), 2 * trp))
    lengths[k] -= lengths[:k + 1].sum() - 2 * trp
    lengths[k + 1:k + 4] = [40 * f, 50 * f, 38 * f]
    keys = np.repeat(np.arange(c), lengths)
    pad = -(-(keys.shape[0] + trp // 2) // trp) * trp - keys.shape[0]
    keys = np.concatenate([keys, np.full(pad, c)]).astype(np.int32)
    r1, r2, r3 = (getattr(prt, f).numpy() for f in ("r1", "r2", "r3"))
    pts = np.concatenate([r1, (r1 + r2) / 2, (r2 + r3) / 2])
    r8 = np.zeros((8, keys.shape[0]), np.float32)
    for k in np.unique(keys[keys < c]):
        at = np.nonzero(keys == k)[0]
        lo, hi = k * cs, min((k + 1) * cs, r1.shape[0])
        own = np.concatenate([pts[lo:hi], pts[r1.shape[0] + lo:
                                              r1.shape[0] + hi]])
        r8[:, at] = _rays(at.shape[0], seed + int(k), aim=own)
    return keys, r8


@pytest.mark.parametrize("cs,trp", [(CS, TRP), (256, 1024)])
def test_k10_visits_and_pair_visits_bit_equal(scenes, cs, trp):
    """At the test's sizes and at the production ones (cs 256, trp 1024:
    XLA's dot at those shapes sums as at the small ones)."""
    if cs == CS:
        jm, _, pmsc, prt, c, _ = scenes
    else:
        _, jrest = jsi.split_by_size(jlib.stress_scene(N_TRIS).tris)
        _, prest = si.split_by_size(library.stress_scene(N_TRIS).tris)
        jm, _, c = jbuild(jrest, cs)
        pmsc, prt, _ = build_march_scene(prest, cs)
    keys, r8 = _sorted_pairs(prt, c, cs, trp, 3)
    assert len(np.unique(keys[2 * trp:3 * trp])) == 3
    assert len(np.unique(keys[:2 * trp])) >= 4
    jvb, jvc = jpm.build_visits(jnp.asarray(keys), trp, c)
    vb, vc = pm.build_visits(torch.from_numpy(keys), trp, c)
    np.testing.assert_array_equal(vb.numpy(), np.asarray(jvb))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(jvc))
    j8 = jnp.asarray(r8)
    jt, jgp = jpm._run_pair_visits(jvb, jvc, j8, jfeat(j8), jm, cs, trp,
                                   True, False, True)
    t, gp = pm.pair_visits(torch.from_numpy(keys), torch.from_numpy(r8),
                           pmsc.trig, pmsc.tric, cs, trp, c)
    np.testing.assert_array_equal(_bits(t), _bits(jt[0]))
    np.testing.assert_array_equal(_bits(gp), _bits(jgp[0]))
    hits = t.numpy() < si.BIG
    pend = gp.numpy() % 2 == 1
    assert hits.mean() > 0.5 and pend.any() and not pend[keys == c].any()


def test_k11_fetch_attrs_bit_equal(scenes):
    jm, _, pmsc, _, c, _ = scenes
    rs = np.random.default_rng(4)
    g = rs.integers(-3, c * CS, 700).astype(np.float32)
    g[:3] = [-1.0, 0.0, c * CS - 1]
    jout = jpm.fetch_attrs(jnp.asarray(g), jm, CS, c, 128, True)
    out = pm.fetch_attrs(torch.from_numpy(g), pmsc.tric)
    for a, b in zip(out, jout):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert not any(a.numpy()[g < 0].any() for a in out)
    assert (out[3].numpy()[g >= 0] > 0).any()


def test_pair_sort_keeps_slot_order_as_jax(scenes):
    """The pair expansion: keys rank-major (pair j R + i), dummy-padded
    to whole tiles, sorted with the rays carried; JAX's `lax.sort`
    (num_keys=1) keeps slot order within a run on the CPU, and the
    port's stable sort gives the same permutation."""
    *_, c, boxes_r = scenes
    r8 = _rays(300, 5)
    ids, _, _ = si.run_candidates(torch.from_numpy(r8),
                                  torch.from_numpy(boxes_r), 6, c)
    comps = [torch.from_numpy(r8[k]) for k in range(6)]
    keys_s, rays8p, order = pm.sort_pairs(comps, ids, c, TRP)
    p = ids.numel()
    ppad = keys_s.shape[0]
    keys = np.concatenate([ids.numpy().reshape(-1),
                           np.full(ppad - p, c, np.int32)])
    jk, js = jax.lax.sort([jnp.asarray(keys),
                           jnp.arange(ppad, dtype=jnp.int32)], num_keys=1)
    np.testing.assert_array_equal(order.numpy(), np.asarray(js))
    np.testing.assert_array_equal(keys_s.numpy(), np.asarray(jk))
    slot = order.numpy()
    real = slot < p
    np.testing.assert_array_equal(rays8p.numpy()[:6, real],
                                  r8[:6, slot[real] % 300])
    assert not rays8p.numpy()[:, ~real].any()


def test_pairs_round_bit_equal(scenes):
    jm, _, pmsc, _, c, boxes_r = scenes
    r8 = np.concatenate([_rays(200, 6), _rays(56, 7, aim=boxes_r[:c, 0:3])],
                        1)
    ids, _, _ = si.run_candidates(torch.from_numpy(r8),
                                  torch.from_numpy(boxes_r), 4, c)
    (t, g), pend = pm.pairs_round_mxu([torch.from_numpy(r8[k])
                                       for k in range(6)], ids, pmsc, c, CS,
                                      TRP)
    (jt, jg), jpend = jpm.pairs_round_mxu(
        [jnp.asarray(r8[k]) for k in range(6)], jnp.asarray(ids.numpy()),
        jm, c, CS, TRP, True, False, True)
    np.testing.assert_array_equal(_bits(t), _bits(jt))
    hit = t.numpy() < si.BIG
    np.testing.assert_array_equal(g.numpy()[hit], np.asarray(jg)[hit])
    np.testing.assert_array_equal(pend.numpy(), np.asarray(jpend))
    assert hit.any()
