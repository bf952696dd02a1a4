"""K12 and the 'pair' accel (the pair intersector at its own defaults:
mxu=False, the VPU pairs round on `build_clusters` packs) in the port
against the JAX package's `sorted_intersect` on stress_scene(1200) (740
triangles, 18 split out; clusters of 128): K12's plain version bit-equal
to interpret-mode `_run_pairs(resident=True)`, dummy pairs included;
`_pairs_round` bit-equal; `make_pair_intersect(cluster_size=128,
trp=128)` bit-equal to JAX's on camera and box rays, and equal to the
port's dense K4; and the port's defaults equal to JAX's.
`test_torch_pair_schedule.py` runs deeper schedules."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.ops.pallas import cluster_kernel as jck
from opencl_path_tracer_tpu.ops.pallas import sorted_intersect as jsi
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import interop
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.ops.kernels import pair_mxu as pm
from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
from opencl_path_tracer_tpu_torch.scene import library
from opencl_path_tracer_tpu_torch.utils import profiling
from test_torch_cluster_kernel import _aimed_rays, _bits
from test_torch_pair_intersect import RAYS, _assert_hits_bit_equal, _both

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

N_TRIS = 1200
CS, TRP = 128, 128


@pytest.fixture(scope="module")
def packs():
    """The JAX package's clusters of the non-spanning triangles, with the
    all-zero dummy cluster last, and the same carried to the port."""
    jt = jlib.stress_scene(N_TRIS).tris
    _, rest = jsi.split_by_size(jt)
    js, c, k = jck.build_clusters(rest, CS, split_large=False)
    tri_pack = jnp.concatenate(
        [js.tri_pack, jnp.zeros((1,) + js.tri_pack.shape[1:], jnp.float32)])
    cs = interop.cluster_scene_from_numpy(np.asarray(js.boxes),
                                          np.asarray(tri_pack))
    boxes_r = torch.zeros((128, 8))
    boxes_r[:c] = cs.boxes[:c]
    return tri_pack, cs.rows(), boxes_r, c, k


def _round_inputs(boxes_r, c, l=4):
    """Rays aimed at small triangles from 30 units away (so most hit in
    the clusters, not on the split-out walls) and their l nearest
    candidate clusters (K9's plain version, bit-equal to JAX's)."""
    p, d = _aimed_rays(library.stress_scene(N_TRIS).tris, 1)
    p, d = p[:250], d[:250]          # pairs padded to whole tiles of TRP
    comps = [torch.from_numpy(np.ascontiguousarray(a[:, j]))
             for a in (p, d) for j in range(3)]
    ids = si.candidates_plain(k1.pack_rays(comps[:3], comps[3:]), boxes_r, l,
                              c)[0]
    return comps, ids


def test_k12_plain_bit_equal_to_interpret_mode(packs):
    tri_pack, rows, boxes_r, c, k = packs
    comps, ids = _round_inputs(boxes_r, c, l=c)
    keys_s, rays8p, _ = pm.sort_pairs(comps, ids, c, TRP)
    assert int((ids == c).sum()) > 0           # dummy pairs ride along
    assert int((keys_s == c).sum()) > int((ids == c).sum())
    jr8 = np.array(rays8p.numpy())
    jr8[6] = keys_s.numpy().astype(np.float32)  # JAX's [p d key 0] rows
    jout = jsi._run_pairs(jnp.asarray(keys_s.numpy()), jnp.asarray(jr8),
                          tri_pack, TRP, True, True)
    pout = si.run_pairs(keys_s, rays8p, rows, k)
    for a, b in zip(pout, jout):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    hit = pout[0] < si.BIG
    assert int(hit.sum()) > 100 and not bool(hit[keys_s == c].any())


def test_pairs_round_bit_equal(packs):
    tri_pack, rows, boxes_r, c, k = packs
    comps, ids = _round_inputs(boxes_r, c, l=3)
    jout = jsi._pairs_round([jnp.asarray(x.numpy()) for x in comps],
                            jnp.asarray(ids.numpy()), tri_pack, TRP, True,
                            True)
    pout = si._pairs_round(comps, ids, rows, k, c, TRP)
    for a, b in zip(pout, jout):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    assert float((pout[0] < si.BIG).float().mean()) > 0.5


@pytest.mark.parametrize("rays", ["camera", "box"])
def test_pair_accel_bit_equal_to_jax(rays):
    js, ps = jlib.stress_scene(N_TRIS), library.stress_scene(N_TRIS)
    jr, pr = _both(*RAYS[rays]())
    jh = jsi.make_pair_intersect(js.tris, cluster_size=CS, trp=TRP,
                                 interpret=True)(jr)
    fn = si.make_pair_intersect(ps.tris, cluster_size=CS, trp=TRP)
    profiling.reset()
    with profiling.tracing(device_counts=True):
        ph = fn(pr)
    _assert_hits_bit_equal(jh, ph)
    pack = k1.build_tri_pack(ps.tris)
    t, _, nx, ny, nz, m = k1.dense(k1.pack_rays(pr.p, pr.d), pack)
    hit = t < k1.BIG
    np.testing.assert_array_equal(ph.t.numpy(),
                                  np.where(hit, t.numpy(), -1.0))
    for a, b in zip(ph.n, (nx, ny, nz)):
        np.testing.assert_array_equal(_bits(a.numpy()[hit.numpy()]),
                                      _bits(b.numpy()[hit.numpy()]))
    stats = profiling.counters()
    assert stats["isect.pending"] == 0 and stats["isect.rays"] == 256


def test_defaults_are_the_jax_package_s():
    def defaults(fn, drop=()):
        return {k: p.default for k, p in inspect.signature(fn).parameters
                .items() if k not in drop}

    assert defaults(si.make_pair_intersect) == defaults(
        jsi.make_pair_intersect, ("interpret",))
    assert defaults(si.make_group_intersect) == defaults(
        jsi.make_group_intersect, ("interpret",))
    from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
    assert defaults(ck.make_cluster_intersect) == defaults(
        jck.make_cluster_intersect, ("interpret",))
    assert si.PAIR_TPU_WINNER == jsi.PAIR_TPU_WINNER
