"""K19 (the flat visit list) and the 'flat' intersector in the port against
the JAX package on the CPU: `_build_visit_list` equals JAX's, with and
without overflow (a starved capacity drops visits and blocks' dummies);
K19's plain version equals interpret-mode `_run_flat` on the blocks the
JAX kernel flushes (a block with no visit under the capacity is never
written there; the port keeps its round-0 rows); the flat intersector's
hits equal JAX's and K4's over the reordered triangles, presorted or
not, and with vcap_frac=0.01."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.ops.pallas import flat_march as jfm
from opencl_path_tracer_tpu.ops.pallas import march_kernel as jmk
from opencl_path_tracer_tpu.ops.pallas.plucker_kernel import (
    plucker_feat as jfeat,
)
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.ops.kernels import flat_march as fm
from opencl_path_tracer_tpu_torch.ops.kernels import march_kernel as mk
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    BIG, make_pallas_intersect,
)
from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
    plucker_feat,
)
from opencl_path_tracer_tpu_torch.scene import library
from test_torch_march_kernel import aimed_rays, bits, to_rays

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

CS = TR = 128


@pytest.mark.parametrize("vcap", [4096, 40, 23])
def test_visit_list_equals_jax(vcap):
    rs = np.random.default_rng(vcap)
    bu = rs.random((9, 14)) < 0.4
    bu[:, 3] = False                      # a block with only its dummy
    jl = jfm._build_visit_list(jnp.asarray(bu), vcap)
    pl = fm._build_visit_list(torch.as_tensor(bu), vcap)
    for k, (a, b) in enumerate(zip(pl, jl)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"output {k}")
    assert bool(pl[3].any()) == (vcap < 4096)
    vb = pl[0].numpy()
    assert (np.diff(vb) >= 0).all()


def test_k19_equals_interpret_mode_on_flushed_blocks():
    jsc, _, c = jmk.build_march_scene(jlib.stress_scene(1200).tris, CS)
    psc, _, _ = mk.build_march_scene(library.stress_scene(1200).tris, CS)
    r8 = aimed_rays(768, 3, jlib.stress_scene(1200).tris)
    pr8 = torch.as_tensor(r8)
    feat = plucker_feat(pr8)
    ent, need = mk._slab_entries(pr8, psc, torch.full((768,), BIG))
    cl = mk._block_lists(ent, need, TR, 1)
    rows0 = mk.run_march(cl, pr8, feat, psc, CS, 1, TR)
    bu = mk._need(ent, rows0[0]).view(c, -1, TR).any(dim=2) & ~mk._visited_from(
        cl, c, 1)
    vb, vc, _, ovf = fm._build_visit_list(bu, 12)   # overflows
    assert bool(ovf.any()) and not bool(ovf.all())
    got = fm.run_flat(vb, vc, pr8, feat, rows0, psc, CS, TR)
    want = jfm._run_flat(jnp.asarray(vb.numpy()), jnp.asarray(vc.numpy()),
                         jnp.asarray(r8), jfeat(jnp.asarray(r8)),
                         tuple(jnp.asarray(rows0[k:k + 1].numpy())
                               for k in range(7)), CS, TR, True, scene=jsc)
    flushed = torch.isin(torch.arange(768 // TR), vb.long()).repeat_interleave(
        TR).numpy()
    for k in range(7):
        np.testing.assert_array_equal(bits(got[k])[flushed],
                                      bits(want[k][0])[flushed],
                                      err_msg=f"row {k}")
    # Unflushed blocks keep their round-0 rows; round 1 improved others.
    assert torch.equal(got[:, ~torch.as_tensor(flushed)],
                       rows0[:, ~torch.as_tensor(flushed)])
    assert bool((got[0] < rows0[0]).any())


@pytest.mark.parametrize("kw", [dict(K0=2), dict(K0=1, presorted=True),
                                dict(K0=1, vcap_frac=0.01)])
def test_flat_intersect_equals_jax_and_k4(kw):
    js, ps = jlib.stress_scene(1200), library.stress_scene(1200)
    r8 = aimed_rays(300, 8, js.tris)
    jr, pr = to_rays(r8)
    ji, _ = jfm.make_flat_march_intersect(js.tris, cs=CS, tr=TR, tail=128,
                                          interpret=True, **kw)
    pi, prt = fm.make_flat_march_intersect(ps.tris, cs=CS, tr=TR, tail=128,
                                           **kw)
    jh, ph = ji(jr), pi(pr)
    np.testing.assert_array_equal(bits(ph.t), bits(jh.t))
    np.testing.assert_array_equal(ph.mati.numpy(), np.asarray(jh.mati))
    for k in range(3):
        np.testing.assert_array_equal(bits(ph.n[k]), bits(jh.n[k]))
    ref = make_pallas_intersect(prt)(pr)
    hit = ref.t > 0
    assert torch.equal(ph.t, ref.t) and torch.equal(ph.mati, ref.mati)
    for k in range(3):
        assert torch.equal(ph.n[k][hit], ref.n[k][hit])
    assert int(hit.sum()) > 250
