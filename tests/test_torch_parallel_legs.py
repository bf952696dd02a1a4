"""The nine legs of `__graft_entry__.dryrun_multichip` as the port's
tests, in one gloo world of 2 ranks on the CPU (`tests/torch_world.py`),
at the dryrun's 16 x (2 x 2) frame.

The dryrun checks that each sharded step runs and gives finite values;
here each rank's rows are also torch.equal to the port's single-device
step on the same lanes: the tiled megakernel (leg 1) and every tiled
wavefront leg (3-9, two steps each) to the single-device model on the
whole frame, the sample-sharded render (leg 2) to the mean of the two
ranks' sample sets rendered in one process."""

import jax
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.ops import rng as jrng
from opencl_path_tracer_tpu_torch.models import megakernel
from opencl_path_tracer_tpu_torch.ops import rng
from opencl_path_tracer_tpu_torch.scene import library

import torch_world as tw

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

W, H, N = tw.W, tw.H, tw.W * tw.H
WAVEFRONT_LEGS = {
    "leg3": "tiled wavefront (the flagship: LBVH walker)",
    "leg4": "pair intersector (mxu, thin, sort) on stress_scene(1200)",
    "leg5": "analytic cornell: minarg + the sphere kernel",
    "leg6": "smooth pair intersector with ids",
    "leg7": "sphere-lamp NEE via the any-hit test, rr, QMC, DOF, adaptive",
    "leg8": "many-light 'distance' NEE",
    "leg9": "the 465 nm band of dispersive_materials(v_d=20)",
}


@pytest.fixture(scope="module")
def world():
    return tw.launch_world(("leg1", "leg2") + tuple(WAVEFRONT_LEGS), 2)


def test_leg1_tiled_megakernel_with_env_light(world):
    """Leg 1: the tiled parity sample with the dormant sky on the flagship:
    each rank's colors and Lehmer states torch.equal to the single-device
    sample's rows, the counter at 1, a finite meter."""
    scene, isect = tw.flagship()
    ref = megakernel.trace_sample(
        library.cornell_camera(W, H), scene.mats,
        megakernel.init_state(N, 1), intersect_fn=isect, iterations=3,
        mode="parity", env=megakernel.EnvLight())
    colors = megakernel.colors_array(ref).numpy()
    for rank, r in enumerate(world):
        rows = slice(rank * N // 2, (rank + 1) * N // 2)
        np.testing.assert_array_equal(r["leg1"]["colors"], colors[rows])
        np.testing.assert_array_equal(r["leg1"]["rng"],
                                      ref.rng_state.numpy()[rows])
        assert r["leg1"]["sample"] == 1 and np.isfinite(r["leg1"]["lum"])


def test_leg2_sample_sharded(world):
    """Leg 2: the sample-sharded flagship render (1 sample a rank): the
    same frame on both ranks, torch.equal to the mean of samples 0 and 1
    rendered in one process (a sum of two is exact in either order)."""
    scene, isect = tw.flagship()
    cam = library.cornell_camera(W, H)
    frames = []
    for k in range(2):
        z = torch.zeros(N)
        st = megakernel.TraceState(colors=(z, z.clone(), z.clone()),
                                   rng_state=torch.zeros(N, dtype=torch.int64),
                                   sample=0)
        st = megakernel.trace_sample(cam, scene.mats, st, intersect_fn=isect,
                                     iterations=3, mode="fast",
                                     key=rng.key(1), sample_index=k)
        frames.append(megakernel.colors_array(st))
    ref = ((frames[0] + frames[1]) / 2).numpy()
    for r in world:
        assert r["leg2"].shape == (N, 3)
        np.testing.assert_array_equal(r["leg2"], ref)


@pytest.mark.parametrize("leg", list(WAVEFRONT_LEGS),
                         ids=[f"{k}-{v.split(' ')[0]}"
                              for k, v in WAVEFRONT_LEGS.items()])
def test_wavefront_leg(world, leg):
    """Legs 3-9: two tiled wavefront steps; each rank's lanes torch.equal
    to the single-device steps' rows, field by field, and the meter
    finite."""
    ref = tw.lanes_np(tw.wf_single(leg))
    for rank, r in enumerate(world):
        rows = slice(rank * N // 2, (rank + 1) * N // 2)
        lanes = r[leg]["lanes"]
        assert lanes["step"] == ref["step"]
        for f, v in ref.items():
            if f == "step":
                continue
            got = lanes[f]
            if isinstance(v, tuple):
                for k in range(3):
                    np.testing.assert_array_equal(got[k], v[k][rows],
                                                  err_msg=f"{leg} {f}")
            else:
                np.testing.assert_array_equal(got, v[rows],
                                              err_msg=f"{leg} {f}")
        assert np.isfinite(r[leg]["lum"])


def test_r2_jitter_takes_per_lane_samples():
    """Leg 7 regenerates QMC camera rays in the wavefront, where each lane
    passes its own sample index: `rng.r2_jitter` with a tensor of them
    equals the JAX package's with an array, bit for bit, and each lane
    equals the scalar call at its index."""
    rs = np.random.default_rng(3)
    pix = rs.integers(0, 1 << 21, 257).astype(np.int32)
    smp = rs.integers(0, 1 << 20, 257).astype(np.int32)
    u, v = rng.r2_jitter(rng.key(5), torch.from_numpy(pix),
                         torch.from_numpy(smp))
    ju, jv = jrng.r2_jitter(jax.random.key(5), pix, smp)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    for j in (0, 100, 256):
        us, vs = rng.r2_jitter(rng.key(5), torch.from_numpy(pix[j:j + 1]),
                               int(smp[j]))
        assert float(us[0]) == float(u[j]) and float(vs[0]) == float(v[j])
