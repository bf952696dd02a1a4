"""The 'pair' intersector's whole schedule in the port against the JAX
package's, bit for bit, in both data-movement modes (`move='gather'` and
`'sort'`), on the open random-triangle scene of
`tests/test_sorted_intersect.py` (1,500 triangles, 512 rays): the
full-capacity configuration of its exactness test (mxu=False, thin=False;
round 1 and one escalation) and a deep one (l1 2, l2 4, l3 8, tail 64)
that runs round 1, all three escalation tiers and the dense tail."""

import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.ops.pallas import sorted_intersect as jsi
from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
from test_torch_cluster_kernel import _both_rays, _rand_tris
from test_torch_pair_intersect import _assert_hits_bit_equal

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

CONFIGS = {
    "full": dict(cluster_size=256, l1=4, l2=12, trp=512, u2_frac=1,
                 u3_frac=1, mxu=False, thin=False),
    "deep": dict(cluster_size=128, l1=2, l2=4, l3=8, tail=64, trp=128),
}


@pytest.fixture(scope="module")
def scene():
    jt, pt = _rand_tris(1500)
    rs = np.random.default_rng(5)
    p = rs.uniform(-60.0, 60.0, size=(512, 3)).astype(np.float32)
    d = rs.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jt, pt, _both_rays(p, d)


@pytest.mark.parametrize("move", ["gather", "sort"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_schedule_bit_equal_to_jax(scene, config, move, monkeypatch):
    jt, pt, (jr, pr) = scene
    kw = dict(CONFIGS[config], move=move)
    jh = jsi.make_pair_intersect(jt, interpret=True, **kw)(jr)
    monkeypatch.setattr(si, "STATS", [])
    ph = si.make_pair_intersect(pt, **kw)(pr)
    _assert_hits_bit_equal(jh, ph)
    stats = si.STATS[0]
    assert int((ph.t > 0).sum()) > 10
    assert stats["round1_resolved"] < stats["rays"]
    if config == "deep":
        assert len(stats["escalations"]) == 3
        assert stats["tail_iterations"] >= 1 and stats["tail_rays"] > 0
