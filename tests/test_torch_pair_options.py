"""The pair intersector's options in the port against the JAX package's
interpret mode, on the same inputs, bit for bit: K10's full form (five
streams, `pair_visits_full_plain` against `_run_pair_visits(thin=False)`)
and its in-kernel features (`infeat`, thin and full), the non-thin pairs
round (`pairs_round_mxu(thin=False)`), and `make_pair_intersect` with the
'pairmx' kwargs (mxu=True, thin=False), `approx` (thin and full: (Hits,
resolved)) and `infeat=True` on stress_scene(1200) with clusters of 128
and pair tiles of 128 (the other pair tests' sizes), on 16x16 camera rays
and random rays in the box (`move='chain'`: test_torch_pair_chain.py). Also the probe behind
`infeat`: inside an interpret-mode kernel `_infeat_rows`' cross products
are fma(a, b, -(c d)), not plucker_feat's separate roundings."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from opencl_path_tracer_tpu.ops.pallas import pair_mxu as jpm
from opencl_path_tracer_tpu.ops.pallas import sorted_intersect as jsi
from opencl_path_tracer_tpu.ops.pallas.plucker_kernel import (
    plucker_feat as jfeat,
)
from opencl_path_tracer_tpu_torch.ops.kernels import pair_mxu as pm
from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
from test_torch_pair_intersect import (
    KW, _assert_hits_bit_equal, _run, scenes,  # noqa: F401 (fixture)
)
from test_torch_pair_kernels import (
    CS, _bits, _rays, _sorted_pairs, scenes as march_scenes,  # noqa: F401
)

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)


def test_infeat_rows_round_as_interpret_mode():
    """The in-kernel features equal `infeat_rows` (fused cross products)
    bit for bit and differ from plucker_feat's on some rays."""
    r8 = np.concatenate([_rays(2048, 11), _rays(2048, 12)], 1)
    r8[0:3] *= 0.37   # other exponents of P x D

    def kern(r_ref, o_ref):
        o_ref[:] = jpm._infeat_rows(r_ref[:]).astype(jnp.float32)

    n = r8.shape[1]
    jout = jax.jit(lambda x: pl.pallas_call(
        kern, grid=(n // 512,),
        in_specs=[pl.BlockSpec((8, 512), lambda i: (0, i))],
        out_specs=pl.BlockSpec((32, 512), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((32, n), jnp.float32),
        interpret=True)(x))(jnp.asarray(r8))
    mine = pm.infeat_rows(torch.from_numpy(r8)).float().numpy()
    np.testing.assert_array_equal(_bits(mine), _bits(jout))
    sep = np.asarray(jfeat(jnp.asarray(r8)).astype(jnp.float32))
    assert (sep[6:9] != mine[6:9]).any()


@pytest.mark.parametrize("infeat", [False, True])
def test_k10_full_and_infeat_bit_equal(march_scenes, infeat):
    """Five streams (t, nx, ny, nz, m * 2 + pend) of the full form, and
    the thin form's two with infeat, against interpret-mode K10."""
    jm, _, pmsc, prt, c, _ = march_scenes
    trp = 128
    keys, r8 = _sorted_pairs(prt, c, CS, trp, 5)
    jvb, jvc = jpm.build_visits(jnp.asarray(keys), trp, c)
    j8 = jnp.asarray(r8)
    featp = None if infeat else jfeat(j8)
    jfull = jpm._run_pair_visits(jvb, jvc, j8, featp, jm, CS, trp, True,
                                 infeat, False)
    args = (torch.from_numpy(keys), torch.from_numpy(r8), pmsc.trig,
            pmsc.tric, CS, trp, c)
    full = pm.pair_visits_full(*args, infeat=infeat)
    for a, b in zip(full, jfull):
        np.testing.assert_array_equal(_bits(a), _bits(b[0]))
    jthin = jpm._run_pair_visits(jvb, jvc, j8, featp, jm, CS, trp, True,
                                 infeat, True)
    thin = pm.pair_visits(*args, infeat=infeat)
    for a, b in zip(thin, jthin):
        np.testing.assert_array_equal(_bits(a), _bits(b[0]))
    # The full form is the thin one with K11's fetch of its winner.
    t, gp = thin
    g = torch.floor(gp / 2.0)
    fetched = pm.fetch_attrs_plain(torch.where(t < si.BIG, g, -1.0),
                                   pmsc.tric)
    for a, b in zip(full[1:4], fetched[:3]):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(_bits(full[4]),
                                  _bits(fetched[3] * 2.0 + (gp - 2.0 * g)))
    hit = t.numpy() < si.BIG
    assert hit.mean() > 0.5 and (gp.numpy() % 2 == 1).any()
    assert not full[1].numpy()[~hit].any()


@pytest.mark.parametrize("infeat", [False, True])
def test_pairs_round_full_bit_equal(march_scenes, infeat):
    """pairs_round_mxu(thin=False): the least t over L = 4 ranks, the
    winner's attributes as the one-hot sum gives them (a winning -0.0
    becomes +0.0), m and pend."""
    jm, _, pmsc, _, c, boxes_r = march_scenes
    r8 = np.concatenate([_rays(200, 6), _rays(56, 7, aim=boxes_r[:c, 0:3])],
                        1)
    ids, _, _ = si.run_candidates(torch.from_numpy(r8),
                                  torch.from_numpy(boxes_r), 4, c)
    comps = [torch.from_numpy(r8[k]) for k in range(6)]
    out, pend = pm.pairs_round_mxu(comps, ids, pmsc, c, CS, 128, thin=False,
                                   infeat=infeat)
    jout, jpend = jpm.pairs_round_mxu(
        [jnp.asarray(r8[k]) for k in range(6)], jnp.asarray(ids.numpy()),
        jm, c, CS, 128, True, infeat, False)
    for a, b in zip(out, jout):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(pend.numpy(), np.asarray(jpend))
    assert (out[0].numpy() < si.BIG).any()


PAIRMX = dict(mxu=True, dop=False, thin=False, move="gather",
              cluster_size=128, trp=128)


@pytest.mark.parametrize("name,kw,rays", [
    ("pairmx", PAIRMX, "camera"),
    ("pairmx", PAIRMX, "box"),
    ("pairmx-sort-infeat", dict(PAIRMX, move="sort", infeat=True), "box"),
    ("winner-infeat", dict(KW, infeat=True), "box"),
], ids=lambda x: x if isinstance(x, str) else "")
def test_make_pair_intersect_options_bit_equal(scenes, name, kw, rays,
                                               monkeypatch):
    """Hits bit-equal to the JAX package's with the same options."""
    jh, ph, stats, _ = _run(scenes, rays, False, monkeypatch,
                            **{k: v for k, v in kw.items() if k not in KW
                               or KW[k] != v})
    _assert_hits_bit_equal(jh, ph)
    assert (ph.t.numpy() > 0).mean() > 0.5 and stats["round1_resolved"] > 0


@pytest.mark.parametrize("thin", [False, True])
def test_approx_bit_equal(scenes, thin, monkeypatch):
    """approx=True: (Hits, resolved) after round 1, bit-equal to JAX's;
    the resolved lanes' hits equal the exact path's."""
    kw = dict(KW, approx=True) if thin else dict(PAIRMX, approx=True)
    over = {k: v for k, v in kw.items() if k not in KW or KW[k] != v}
    (jh, jres), (ph, pres), stats, pr = _run(scenes, "box", False,
                                             monkeypatch, **over)
    _assert_hits_bit_equal(jh, ph)
    np.testing.assert_array_equal(pres.numpy(), np.asarray(jres))
    res = pres.numpy()
    assert 0.3 < res.mean() < 1.0 and stats["round1_resolved"] == res.sum()
    exact = si.make_pair_intersect(scenes[1].tris,
                                   **dict(kw, approx=False))(pr)
    np.testing.assert_array_equal(_bits(ph.t.numpy()[res]),
                                  _bits(exact.t.numpy()[res]))
    np.testing.assert_array_equal(ph.mati.numpy()[res],
                                  exact.mati.numpy()[res])
