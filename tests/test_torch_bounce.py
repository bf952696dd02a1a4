"""K21's packed fast-mode sample (`models/bounce.py`) on the CPU, where
its plain versions run: bit-equal to the megakernel's plain path
(`megakernel.trace_sample_plain`), colours and rays traced; the
dispatch predicate as a function of the call's inputs; the wrapper's
checks; the device table against K5's layout; the spans and counters of
both paths. The kernel itself is held against the plain path on the
card (`tests/test_torch_cuda.py::test_bounce_kernel_path_equals_plain_path`,
`chip_smoke.py`'s `check_bounce`)."""

import dataclasses

import pytest
import torch

from opencl_path_tracer_tpu_torch.core.types import Rays
from opencl_path_tracer_tpu_torch.models import bounce, fused_step, megakernel
from opencl_path_tracer_tpu_torch.ops import rng
from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
from opencl_path_tracer_tpu_torch.scene import library
from opencl_path_tracer_tpu_torch.utils import profiling

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

W = H = 16
ITERS = 5


@pytest.fixture(scope="module")
def cornell():
    scene = library.cornell_box(with_spheres=True)
    return scene, library.cornell_camera(W, H), make_intersect_fn(
        scene, "minarg")


def _textured(isect):
    """A (Hits, kd_scale) intersector: per-lane kd multipliers in
    [0.25, 1) from the hit point, as a textured intersector returns."""
    def fn(rays):
        hit = isect(rays)
        kd = tuple(0.25 + 0.75 * torch.frac(hit.p[k] * (0.013 + 0.007 * k))
                   .abs() for k in range(3))
        return hit, kd
    return fn


def _render(trace, cam, mats, isect, seed, samples, **kw):
    st = megakernel.init_state(W * H, seed)
    rays = []
    for s in range(samples):
        st, r = trace(cam, mats, st, intersect_fn=isect, iterations=ITERS,
                      key=rng.key(seed), with_stats=True,
                      sample_index=None if s == 0 else 100 + s, **kw)
        rays.append(r)
    return st, rays


@pytest.mark.parametrize("case", ["seed 1", "seed 2", "seed 3",
                                  "textured"])
def test_packed_path_equals_plain_path(cornell, case):
    """Three samples on 16x16 lanes at 5 bounces from a tile offset of
    37 pixels, the sample index overridden after the first: the packed
    path's colours, rays traced and sample count are the plain path's,
    bit for bit."""
    scene, cam, isect = cornell
    seed = 7 if case == "textured" else int(case.split()[1])
    if case == "textured":
        isect = _textured(isect)
    a, ra = _render(megakernel.trace_sample_plain, cam, scene.mats, isect,
                    seed, 3, mode="fast", ids=37)
    b, rb = _render(bounce.trace_sample, cam, scene.mats, isect, seed, 3,
                    ids=37)
    assert a.sample == b.sample == 3
    for k in range(3):
        assert torch.equal(a.colors[k], b.colors[k])
    assert torch.equal(a.rng_state, b.rng_state)
    for x, y in zip(ra, rb):
        assert x.dtype == y.dtype == torch.float32 and x.shape == y.shape
        assert torch.equal(x, y)
    assert float(rb[0]) > W * H  # bounces past the first were counted


KERNEL_CALL = dict(device=torch.device("cuda"), mode="fast", qmc=False,
                   nee=None, env=None, dof=None, iterations=5)
PLAIN_CALLS = {
    "cpu": dict(device=torch.device("cpu")),
    "parity": dict(mode="parity"),
    "qmc": dict(qmc=True),
    "nee": dict(nee=object()),
    "env": dict(env=megakernel.EnvLight()),
    "dof": dict(dof=(20.0, 600.0)),
    "preview": dict(iterations=1),
}


@pytest.mark.parametrize("change", [None, *PLAIN_CALLS])
def test_dispatch_predicate(change):
    """The packed path only for a CUDA state in fast mode without QMC,
    NEE, environment or DOF, at more than one bounce; each condition
    alone sends a call to the plain path."""
    call = dict(KERNEL_CALL, **PLAIN_CALLS.get(change, {}))
    assert bounce.use_kernel(**call) is (change is None)


def test_cpu_calls_take_the_plain_path_and_count_it(cornell):
    """megakernel.trace_sample on the CPU runs the plain path (its spans
    and `step.bounces.plain`); the packed path opens step.raygen,
    step.bounce, isect and step.shade, and neither step.rng nor
    step.fold."""
    scene, cam, isect = cornell
    st = megakernel.init_state(W * H, 1)
    kw = dict(intersect_fn=isect, iterations=ITERS, key=rng.key(1))
    profiling.reset()
    with profiling.tracing():
        megakernel.trace_sample(cam, scene.mats, st, mode="fast", **kw)
    names = {s.name for s in profiling.spans()}
    assert {"step.rng", "step.fold"} <= names
    assert profiling.counters()["step.bounces.plain"] == ITERS
    profiling.reset()
    with profiling.tracing():
        bounce.trace_sample(cam, scene.mats, st, **kw)
    names = {s.name for s in profiling.spans()}
    assert {"step", "step.raygen", "step.bounce", "isect",
            "step.shade"} <= names
    assert not names & {"step.rng", "step.fold"}
    assert profiling.counters()["step.bounces.plain"] == ITERS
    profiling.reset()


def test_wrapper_checks_and_cpu_counts_no_launch(cornell):
    scene, cam, isect = cornell
    n = W * H
    key = rng.fold_in(rng.key(1), 0)
    before = dict(_build.launches)
    S, flags = bounce.raygen(cam, None, n, 0, 0, key)
    assert S.shape == (bounce.S_ROWS, n) and flags.dtype == torch.int32
    hit = isect(Rays(p=(S[0], S[1], S[2]), d=(S[3], S[4], S[5])))
    counter = torch.zeros(1, dtype=torch.int64)
    S2, f2 = bounce.bounce(S, flags, hit, None, cam, scene.mats, None, 0, 1,
                           key, counter)
    assert _build.launches == before
    assert S2.shape == S.shape and int(counter) == n
    cols = bounce.bounce(S2, f2, hit, None, cam, scene.mats, None, 0, 2, key,
                         fold=(tuple(torch.zeros(n) for _ in range(3)), 0.0,
                               1.0))
    assert cols.shape == (3, n) and _build.launches == before
    with pytest.raises(TypeError):                   # flags must be int32
        bounce.bounce(S, flags.float(), hit, None, cam, scene.mats, None, 0,
                      1, key)
    with pytest.raises(ValueError):                  # 20 state rows
        bounce.bounce(S[:20], flags, hit, None, cam, scene.mats, None, 0, 1,
                      key)
    with pytest.raises(ValueError):                  # a strided hit row
        bad = dataclasses.replace(hit, t=torch.zeros(2 * n)[::2])
        bounce.bounce(S, flags, bad, None, cam, scene.mats, None, 0, 1, key)
    with pytest.raises(TypeError):                   # an int32 counter
        bounce.bounce(S, flags, hit, None, cam, scene.mats, None, 0, 1, key,
                      torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):                  # a short kd_scale row
        bounce.bounce(S, flags, hit, (torch.ones(n),) * 2 + (
            torch.ones(n - 1),), cam, scene.mats, None, 0, 1, key)


def test_scene_table_is_k5_layout(cornell):
    """The device table holds K5's fused_table values: the camera's four
    vectors, then 16 floats a material (its last 4 camera floats are
    zeros: the kernel takes the screen size as arguments)."""
    scene, cam, _ = cornell
    tab = bounce.scene_table(cam, scene.mats)
    ref = fused_step.fused_table(cam, scene.mats, W, H)
    assert tab.shape == ref.shape and tab.dtype == torch.float32
    assert torch.equal(tab[:12], ref[:12])
    assert torch.equal(tab[bounce.CAM_COLS:], ref[fused_step.CAM_COLS:])
    assert not tab[12:16].any()
