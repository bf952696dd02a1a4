"""The pair intersector (`accel='pairwin'`) in the port against the JAX
package's `make_pair_intersect(**PAIR_TPU_WINNER, cluster_size=128,
trp=128, interpret=True)` on stress_scene(1200) (740 triangles, 18 of
them scene-spanning, 6 clusters): t, p, n and mati bit-equal on 16x16
camera rays and on random rays inside the box, with and without ids
(ids equal); the hits equal to the port's dense K4 (plain) over the
whole scene, with no exact-t tie between distinct triangles at these
inputs; a forced-pend case (every pairs round reports every ray pending,
on both sides) that sends every ray through a dense tail of 64 rays, in
several iterations (test_torch_stress.py runs a deeper schedule)."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.core.types import Rays as JRays
from opencl_path_tracer_tpu.ops.pallas import pair_mxu as jpm
from opencl_path_tracer_tpu.ops.pallas import sorted_intersect as jsi
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.core.types import Rays
from opencl_path_tracer_tpu_torch.ops import raygen, rng
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.ops.kernels import pair_mxu as pm
from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

N_TRIS = 1200
KW = dict(si.PAIR_TPU_WINNER, cluster_size=128, trp=128)


@pytest.fixture(scope="module")
def scenes():
    return jlib.stress_scene(N_TRIS), library.stress_scene(N_TRIS)


def _camera_rays():
    cam = library.cornell_camera(16, 16)
    s1, r1 = rng.lehmer_step(rng.seed_pixel_streams(256, 1))
    _, r2 = rng.lehmer_step(s1)
    rays = raygen.camera_rays(cam, raygen.pixel_ids(16, 16, "cpu"), r1, r2)
    return (np.stack([x.numpy() for x in rays.p], 1),
            np.stack([x.numpy() for x in rays.d], 1))


def _box_rays(n=256, seed=1):
    rs = np.random.default_rng(seed)
    p = rs.uniform(50, 950, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    return p, d / np.linalg.norm(d, axis=1, keepdims=True)


RAYS = {"camera": _camera_rays, "box": _box_rays}


def _both(p, d):
    return (JRays.make(jnp.asarray(p), jnp.asarray(d)),
            Rays(p=tuple(torch.from_numpy(p[:, k].copy()) for k in range(3)),
                 d=tuple(torch.from_numpy(d[:, k].copy()) for k in range(3))))


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _assert_hits_bit_equal(jh, ph):
    np.testing.assert_array_equal(_bits(ph.t.numpy()), _bits(jh.t))
    np.testing.assert_array_equal(ph.mati.numpy(), np.asarray(jh.mati))
    for k in range(3):
        np.testing.assert_array_equal(_bits(ph.p[k].numpy()), _bits(jh.p[k]))
        np.testing.assert_array_equal(_bits(ph.n[k].numpy()), _bits(jh.n[k]))


def _run(scenes, rays, with_ids, monkeypatch, **kw):
    """Both intersectors on the same rays: (JAX's result, the port's, the
    port's schedule counts, the port's rays)."""
    js, ps = scenes
    jr, pr = _both(*RAYS[rays]())
    jf = jsi.make_pair_intersect(js.tris, interpret=True, with_ids=with_ids,
                                 **dict(KW, **kw))
    pf = si.make_pair_intersect(ps.tris, with_ids=with_ids, **dict(KW, **kw))
    monkeypatch.setattr(si, "STATS", [])
    pout = pf(pr)
    return jf(jr), pout, si.STATS[0], pr


@pytest.mark.parametrize("rays", ["camera", "box"])
@pytest.mark.parametrize("with_ids", [False, True])
def test_pairwin_bit_equal_to_jax(scenes, rays, with_ids, monkeypatch):
    jout, pout, stats, pr = _run(scenes, rays, with_ids, monkeypatch)
    if with_ids:
        (jh, jids), (ph, pids) = jout, pout
        np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    else:
        jh, ph = jout, pout
    _assert_hits_bit_equal(jh, ph)
    # The exact contract: the same hits as the dense K4 over the scene.
    tris = scenes[1].tris
    pack = k1.build_tri_pack(tris)
    t, g, nx, ny, nz, m = k1.dense(k1.pack_rays(pr.p, pr.d), pack)
    hit = t < k1.BIG
    np.testing.assert_array_equal(ph.t.numpy(),
                                  np.where(hit, t.numpy(), -1.0))
    np.testing.assert_array_equal(ph.mati.numpy()[hit.numpy()],
                                  m.numpy()[hit.numpy()].astype(np.int32))
    for a, b in zip(ph.n, (nx, ny, nz)):
        np.testing.assert_array_equal(_bits(a.numpy()[hit.numpy()]),
                                      _bits(b.numpy()[hit.numpy()]))
    if with_ids:
        np.testing.assert_array_equal(
            pids.numpy(), np.where(hit, g.numpy(), -1.0).astype(np.int32))
    # No exact-t tie between distinct triangles at these inputs.
    tt, valid = k1.exact_test(pack, k1.pack_rays(pr.p, pr.d))
    ties = (valid & (tt == t[None, :])).sum(0)
    assert int((ties[hit] > 1).sum()) == 0
    assert hit.float().mean() > 0.9 and stats["round1_resolved"] > 200


@pytest.mark.parametrize("with_ids", [False, True])
def test_forced_pend_funnels_through_the_tail(scenes, monkeypatch, with_ids):
    """Every ray of every pairs round pending (on both sides): only the
    dense tail may resolve them, 64 rays at a time."""
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
    jout, pout, stats, _ = _run(scenes, "box", with_ids, monkeypatch,
                                tail=64)
    if with_ids:
        (jh, jids), (ph, pids) = jout, pout
        np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    else:
        jh, ph = jout, pout
    _assert_hits_bit_equal(jh, ph)
    assert stats["round1_resolved"] == 0 and stats["tail_iterations"] >= 4


@pytest.mark.parametrize("kw", [
    dict(move="chain"), dict(infeat=True), dict(approx=True),
    dict(thin=False, dop=False), dict(thin=False), None],
    ids=["chain", "infeat", "approx", "full-nodop", "full", "value-errors"])
def test_unported_configurations_refuse(scenes, kw, monkeypatch):
    """The five configurations that raised NotImplementedError until they
    were ported (move='chain', infeat, approx and mxu=True with
    thin=False, the `pairmx` payload, with and without DOP boxes) build
    and match the JAX package bit for bit on random rays in the box
    (approx: its resolved flags too); invalid combinations raise the JAX
    package's ValueErrors, as its own function does."""
    if kw is not None:
        jout, pout, _, _ = _run(scenes, "box", False, monkeypatch, **kw)
        if kw.get("approx"):
            (jout, jres), (pout, pres) = jout, pout
            np.testing.assert_array_equal(pres.numpy(), np.asarray(jres))
        _assert_hits_bit_equal(jout, pout)
        return
    tris = library.stress_scene(N_TRIS).tris
    jt = jlib.stress_scene(N_TRIS).tris
    for kw in (dict(dop=True), dict(thin=True), dict(infeat=True),
               dict(with_ids=True), dict(move="scatter"),
               dict(mxu=True, thin=True, move="chain", l3=64),
               dict(mxu=True, thin=True, approx=True, with_ids=True)):
        for fn, t in ((si.make_pair_intersect, tris),
                      (jsi.make_pair_intersect, jt)):
            with pytest.raises(ValueError):
                fn(t, **kw)
