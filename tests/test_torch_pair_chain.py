"""`make_pair_intersect(move='chain')` in the port against the JAX
package's interpret mode, hits bit for bit, on stress_scene(1200) with
`PAIR_TPU_WINNER`'s other settings at clusters of 128 and pair tiles of
128: on 16x16 camera rays and random rays in the box at the default
tiers and at shallow ranks (l1 1, l2 2: the region sorts between the
tiers), and with every pairs round forced pending on both sides, so
that every ray goes through the chain's dense tail (K1 over the
march-ordered triangles, in chunks) and, past the chain's region of u2
rays, through the full-width tail. The chain breaks exact-t ties by the
march-ordered row, so it is held to JAX's chain; the hits also equal
the dense K4's over the whole scene here (no exact-t tie between
distinct triangles at these inputs). `STATS` records the chain's tiers
as the JAX package's code sets them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.core.types import Rays as JRays
from opencl_path_tracer_tpu.ops.pallas import pair_mxu as jpm
from opencl_path_tracer_tpu.ops.pallas import sorted_intersect as jsi
from opencl_path_tracer_tpu_torch.core.types import Rays
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.ops.kernels import pair_mxu as pm
from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
from test_torch_pair_intersect import (
    KW, _assert_hits_bit_equal, _box_rays, _run, scenes,  # noqa: F401
)

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

CHAIN = dict(KW, move="chain")


def _tiers(kw, rpad, clusters):
    """The chain's escalations (capacity, window) as the JAX package's
    chain sets them (sorted_intersect.py:1380-1395)."""
    unit = max(kw["trp"], 512)
    l1, l2 = kw.get("l1", 2), kw.get("l2", 6)
    maxrank = min(kw.get("l3", 48), clusters)
    u2 = max(unit, rpad // 2 // unit * unit)
    tiers = [(u2, l2 - l1)] if l2 > l1 else []
    if maxrank > l2:
        tiers += [(max(unit, rpad // 2 // 4 // unit * unit), 8),
                  (max(unit, rpad // 2 // 16 // unit * unit), maxrank - l2)]
    return tiers, u2


@pytest.mark.parametrize("rays", ["camera", "box"])
@pytest.mark.parametrize("shallow", [False, True])
def test_chain_bit_equal_to_jax(scenes, rays, shallow, monkeypatch):
    kw = dict(l1=1, l2=2, l3=12) if shallow else {}
    jh, ph, stats, pr = _run(scenes, rays, False, monkeypatch,
                             move="chain", **kw)
    _assert_hits_bit_equal(jh, ph)
    tiers, _ = _tiers(dict(CHAIN, **kw), 512, clusters=6)
    assert [e[:2] for e in stats["escalations"]] == tiers
    t, *_ = k1.dense(k1.pack_rays(pr.p, pr.d), k1.build_tri_pack(
        scenes[1].tris))
    np.testing.assert_array_equal(
        ph.t.numpy(), np.where(t.numpy() < k1.BIG, t.numpy(), -1.0))


def test_chain_forced_pend_runs_both_tails(scenes, monkeypatch):
    """Every pairs round pending: the chain's tail takes its region of u2
    = 512 rays in chunks of 128, the full-width tail the 1,024 past it in
    eight iterations of 128."""
    real_j, real_p = jpm.pairs_round_mxu, pm.pairs_round_mxu

    def all_pend_j(comps, ids, scene, c, cs, trp, interpret, infeat=False,
                   thin=False):
        best, pend = real_j(comps, ids, scene, c, cs, trp, interpret,
                            infeat, thin)
        return best, jnp.ones_like(pend)

    def all_pend_p(comps, ids, scene, c, cs, trp, **kw):
        best, pend = real_p(comps, ids, scene, c, cs, trp, **kw)
        return best, torch.ones_like(pend)

    monkeypatch.setattr(jpm, "pairs_round_mxu", all_pend_j)
    monkeypatch.setattr(pm, "pairs_round_mxu", all_pend_p)
    monkeypatch.setattr(si, "STATS", [])
    p, d = _box_rays(1100, seed=3)
    js, ps = scenes
    kw = dict(CHAIN, l1=1, l2=2, tail=128)
    jh = jsi.make_pair_intersect(js.tris, interpret=True, **kw)(
        JRays.make(jnp.asarray(p), jnp.asarray(d)))
    ph = si.make_pair_intersect(ps.tris, **kw)(
        Rays(p=tuple(torch.from_numpy(p[:, k].copy()) for k in range(3)),
             d=tuple(torch.from_numpy(d[:, k].copy()) for k in range(3))))
    _assert_hits_bit_equal(jh, ph)
    stats = si.STATS[0]
    assert stats["round1_resolved"] == 0
    assert stats["chain_tail_rays"] == 512
    assert stats["chain_tail_iterations"] == 4
    assert stats["tail_rays"] == 1024 and stats["tail_iterations"] == 8
