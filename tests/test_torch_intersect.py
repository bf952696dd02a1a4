"""The port's plain intersectors (`ops/intersect.py`) against the JAX
package's XLA forms.

The JAX brute force sums its dot products inside matmuls, in an order
no elementwise form reproduces, so winners and t are compared to float32
rounding: the same hit/miss and winner on all but grazing lanes
(at most 1 in 500 here) and t within rtol 1e-5. `merge_hits` is exact."""

import jax.numpy as jnp
import numpy as np
import torch

from opencl_path_tracer_tpu.core.types import Hits as JHits
from opencl_path_tracer_tpu.core.types import Rays as JRays
from opencl_path_tracer_tpu.ops import intersect as jisect
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.core.types import Hits, Rays
from opencl_path_tracer_tpu_torch.ops import intersect
from opencl_path_tracer_tpu_torch.scene import library as plib

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)


def _rays(n, seed):
    rs = np.random.default_rng(seed)
    p = np.stack([rs.uniform(-100, 1100, n), rs.uniform(0, 1000, n),
                  rs.uniform(-1000, 1000, n)], 1).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (JRays(p=tuple(jnp.asarray(p[:, k]) for k in range(3)),
                  d=tuple(jnp.asarray(d[:, k]) for k in range(3))),
            Rays(p=tuple(torch.from_numpy(p[:, k].copy()) for k in range(3)),
                 d=tuple(torch.from_numpy(d[:, k].copy())
                         for k in range(3))))


def test_first_intersect_ids_near_xla_brute_force():
    js = jlib.cornell_box(with_spheres=True)
    ps = plib.cornell_box(with_spheres=True)
    jr, pr = _rays(1000, 4)
    jh, jid = jisect.first_intersect_ids(jr, js.tris)
    ph, pid = intersect.first_intersect_ids(pr, ps.tris)
    same = pid.numpy() == np.asarray(jid)
    assert (~same).sum() <= 2
    np.testing.assert_allclose(ph.t.numpy()[same], np.asarray(jh.t)[same],
                               rtol=1e-5)
    np.testing.assert_array_equal(ph.mati.numpy()[same],
                                  np.asarray(jh.mati)[same])
    for k in range(3):
        np.testing.assert_array_equal(ph.n[k].numpy()[same],
                                      np.asarray(jh.n[k])[same])
    miss = pid.numpy() < 0
    assert (ph.t.numpy()[miss] == -1.0).all()


def test_merge_hits_matches_and_triangles_win_ties():
    rs = np.random.default_rng(0)
    n = 64
    ta = rs.choice([-1.0, 1.0, 2.0, 3.0], n).astype(np.float32)
    tb = rs.choice([-1.0, 1.0, 2.0, 3.0], n).astype(np.float32)
    fields = [rs.random((7, n)).astype(np.float32) for _ in range(2)]
    ma, mb = np.full(n, 1, np.int32), np.full(n, 2, np.int32)

    def mk(cls, arr, t, f, m):
        return cls(t=arr(t), p=tuple(arr(f[k]) for k in range(3)),
                   n=tuple(arr(f[3 + k]) for k in range(3)), mati=arr(m))

    jm = jisect.merge_hits(mk(JHits, jnp.asarray, ta, fields[0], ma),
                           mk(JHits, jnp.asarray, tb, fields[1], mb))
    pm = intersect.merge_hits(
        mk(Hits, lambda a: torch.from_numpy(np.ascontiguousarray(a)), ta,
           fields[0], ma),
        mk(Hits, lambda a: torch.from_numpy(np.ascontiguousarray(a)), tb,
           fields[1], mb))
    np.testing.assert_array_equal(pm.t.numpy(), np.asarray(jm.t))
    np.testing.assert_array_equal(pm.mati.numpy(), np.asarray(jm.mati))
    for k in range(3):
        np.testing.assert_array_equal(pm.n[k].numpy(), np.asarray(jm.n[k]))
    tie = (ta == tb) & (ta > 0)
    assert tie.any() and (pm.mati.numpy()[tie] == 1).all()
