"""K13a (Plucker top-2 candidates) and K13b (their exact refine) in the
port against the JAX package's Pallas kernels run in interpret mode, on
the same inputs: the packs and features bit-equal, the candidates and
refined rows bit-equal with equal pending masks; and the module's
central guarantee in the port: refined hits bit-equal to K4 on every
non-pending lane (tests/test_plucker.py)."""

import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.ops.pallas import plucker_kernel as jpk
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k4
from opencl_path_tracer_tpu_torch.ops.kernels import plucker_kernel as k13
from opencl_path_tracer_tpu_torch.scene import library
from test_torch_dense_kernel import (
    cornell_rays, rand_rays, rand_scene, rays8_both,
)

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

TR = 128


def _case(name):
    if name == "cornell":
        return (jlib.cornell_box(with_spheres=True).tris,
                library.cornell_box(with_spheres=True).tris) + cornell_rays()
    t, n = {"t60": (60, 300), "t700": (700, 500)}[name]
    return rand_scene(t) + rand_rays(n)


def _bits(bf16):
    return bf16.view(torch.int16).numpy()


@pytest.mark.parametrize("name", ["t60", "t700", "cornell"])
def test_packs_and_features_bit_equal(name):
    jtris, ptris, p, d = _case(name)
    jtrig, jtric, jtpad = jpk.build_plucker_packs(jtris)
    trig, tric, tpad = k13.build_plucker_packs(ptris)
    assert tpad == jtpad
    np.testing.assert_array_equal(_bits(trig),
                                  np.asarray(jtrig).view(np.int16))
    np.testing.assert_array_equal(tric.numpy(), np.asarray(jtric))
    j8, p8 = rays8_both(p, d, TR)
    np.testing.assert_array_equal(
        _bits(k13.plucker_feat(p8)),
        np.asarray(jpk.plucker_feat(j8)).view(np.int16)[:, :p.shape[0]])


@pytest.mark.parametrize("name", ["t60", "t700", "cornell"])
def test_candidates_and_refine_bit_equal(name):
    jtris, ptris, p, d = _case(name)
    r = p.shape[0]
    j8, p8 = rays8_both(p, d, TR)
    jtrig, jtric, jtpad = jpk.build_plucker_packs(jtris)
    jcand = jpk._run_candidates(j8, jtrig, jtric, jpk.plucker_feat(j8), TR,
                                min(1024, jtpad), 256, True)
    trig, tric, _ = k13.build_plucker_packs(ptris)
    cand = k13.candidates(p8, trig, tric, live=ptris.count)
    for row, what in enumerate(("t1", "g1", "t2", "g2")):
        np.testing.assert_array_equal(cand[row].numpy(),
                                      np.asarray(jcand[row])[0, :r],
                                      err_msg=what)
    jrows = [np.asarray(x)[0, :r] for x in
             jpk.make_plucker_intersect(jtris, tr=TR, interpret=True).rows(j8)]
    rows = k13.make_plucker_intersect(ptris).rows(p8).numpy()
    for row, what in enumerate(("t", "nx", "ny", "nz", "mati", "pending")):
        np.testing.assert_array_equal(rows[row].view(np.int32),
                                      jrows[row].view(np.int32), err_msg=what)


@pytest.mark.parametrize("name", ["t60", "t700", "cornell"])
def test_refined_hits_bit_equal_to_dense_where_not_pending(name):
    _, ptris, p, d = _case(name)
    _, p8 = rays8_both(p, d, TR)
    rows = k13.make_plucker_intersect(ptris).rows(p8)
    ref = k4.dense(p8, k4.build_tri_pack(ptris))
    ok = rows[5] == 0.0
    ref_t = torch.where(ref[0] < k4.BIG, ref[0], torch.full_like(ref[0], -1))
    assert torch.equal(rows[0][ok], ref_t[ok])
    hit = ok & (ref_t > 0)
    assert torch.equal(rows[4][hit], ref[5][hit])
    for c in range(3):
        assert torch.equal(rows[1 + c][hit], ref[2 + c][hit])
    assert ok.float().mean() > 0.98            # pending is the rare escape
    assert hit.any()


def test_pending_set_at_1080p_equals_jax():
    """2,048 camera rays of the Cornell box at 1920x1080 (seeded random
    pixels, the jitter of tests/test_plucker.py): the port's rows, pending
    mask included, bit-equal to JAX's interpret-mode kernels. Both flag
    about 1 % of these lanes PENDING; the eps band is fixed in world
    units, so the rate does not fall with the pixel size."""
    import jax.numpy as jnp
    from opencl_path_tracer_tpu.ops import raygen as jraygen
    n = 2048
    ids = np.sort(np.random.default_rng(5).choice(1920 * 1080, n, False))
    rays = jraygen.camera_rays(jlib.cornell_camera(1920, 1080),
                               jnp.asarray(ids, jnp.int32),
                               jnp.full((n,), 0.3, jnp.float32),
                               jnp.full((n,), 0.7, jnp.float32))
    p = np.stack([np.asarray(c) for c in rays.p], 1)
    d = np.stack([np.asarray(c) for c in rays.d], 1)
    j8, p8 = rays8_both(p, d, TR)
    jtris = jlib.cornell_box(with_spheres=True).tris
    jrows = np.stack([np.asarray(x)[0, :n] for x in jpk.make_plucker_intersect(
        jtris, tr=TR, interpret=True).rows(j8)])
    rows = k13.make_plucker_intersect(
        library.cornell_box(with_spheres=True).tris).rows(p8).numpy()
    np.testing.assert_array_equal(rows.view(np.int32), jrows.view(np.int32))
    rate = float((jrows[5] > 0).mean())
    assert 0.002 < rate < 0.03, f"pending rate {rate}"


def test_miss_rays_are_confirmed_not_pending():
    _, ptris = rand_scene(40, spread=5.0)
    p8 = torch.zeros((8, 128))
    p8[0:3] = 100.0
    p8[3] = 1.0                                # heading +x, away from it all
    rows = k13.make_plucker_intersect(ptris).rows(p8)
    assert (rows[5] == 0).all() and (rows[0] == -1).all()


def test_wrapper_checks_and_cpu_counts_no_launch():
    _, ptris = rand_scene(20)
    trig, tric, _ = k13.build_plucker_packs(ptris)
    pack = k4.build_tri_pack(ptris)
    before = dict(_build.launches)
    cand = k13.candidates(torch.zeros((8, 10)), trig, tric,
                          live=ptris.count)
    k13.refine(torch.zeros((8, 10)), cand, pack)
    assert _build.launches == before
    with pytest.raises(ValueError):
        k13.candidates(torch.zeros((8, 10)), trig, tric, chunk=100,
                       live=ptris.count)
    with pytest.raises(TypeError):
        k13.candidates(torch.zeros((8, 10)), trig.float(), tric,
                       live=ptris.count)
    with pytest.raises(ValueError):
        k13.refine(torch.zeros((8, 10)), cand[:3], pack)
