"""The port's recorder (`utils/profiling.py`: spans and counters) on the
CPU: off, it keeps nothing and dispatches no extra operation; one
`trace_sample` at 16 x 16 makes the span tree the benchmark reads
(nesting, parent ids, the sample index, self times); the set-up spans of
an engine are kept on or off; the adaptive render follows a bare
profiler; the counters, the bound on records and
the device-valued counts; the pair schedule's host reads counted; a
program span brackets a `record_function` inside it on the profiler's
clock; `trace_profile` writes the spans into its Chrome trace."""

import collections
import glob
import json
import os

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from opencl_path_tracer_tpu_torch.config import RenderConfig
from opencl_path_tracer_tpu_torch.models import megakernel
from opencl_path_tracer_tpu_torch.ops import nee as nee_ops
from opencl_path_tracer_tpu_torch.ops import raygen, rng
from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
from opencl_path_tracer_tpu_torch.ops.kernels.tilecull_kernel import (
    make_scene_occluded,
)
from opencl_path_tracer_tpu_torch.runtime.engine import (
    RenderEngine, make_intersect_fn,
)
from opencl_path_tracer_tpu_torch.scene import library
from opencl_path_tracer_tpu_torch.utils import profiling

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

BOUNCES = 5


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder in place of the process's."""
    r = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", r)
    return r


@pytest.fixture(scope="module")
def cornell():
    scene = library.cornell_box(with_spheres=True)
    cam = library.cornell_camera(16, 16)
    return scene, cam, make_intersect_fn(scene, "auto")


def _sample(cornell, nee=False, sample=3):
    scene, cam, isect = cornell
    state = megakernel.init_state(16 * 16, 7)
    state = megakernel.TraceState(state.colors, state.rng_state, sample)
    table = (nee_ops.build_emitter_table(scene.tris, scene.mats)
             if nee else None)
    return megakernel.trace_sample(
        cam, scene.mats, state, intersect_fn=isect, iterations=BOUNCES,
        mode="fast", key=rng.key(11), with_stats=True, nee=table,
        occluded_fn=make_scene_occluded(scene) if nee else None)


class _Ops(TorchDispatchMode):
    """Counts the aten operations dispatched."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_off_keeps_nothing_and_adds_no_operation(rec, cornell):
    assert not rec.refresh()
    assert profiling.span("step") is profiling.span("isect")  # the null
    with _Ops() as off:
        st_off, rays_off = _sample(cornell, nee=True)
    profiling.count("host_reads.engine.sync")
    assert rec.spans() == [] and rec.counters() == {}
    with profiling.tracing():
        with _Ops() as on:
            st_on, rays_on = _sample(cornell, nee=True)
    assert rec.spans() and on.n == off.n
    assert all(torch.equal(a, b) for a, b in zip(st_on.colors,
                                                 st_off.colors))
    assert float(rays_on) == float(rays_off)


def test_one_sample_is_one_span_tree(rec, cornell):
    with profiling.tracing():
        _sample(cornell, nee=True, sample=3)
    sp = rec.spans()
    by_id = {s.id: s for s in sp}
    roots = [s for s in sp if s.parent == -1]
    assert [s.name for s in roots] == ["step"]
    root = roots[0]
    kids = [s.name for s in sp if s.parent == root.id]
    assert kids == ["step.raygen"] + ["step.bounce"] * BOUNCES + [
        "step.fold"]
    for b in (s for s in sp if s.name == "step.bounce"):
        names = [s.name for s in sp if s.parent == b.id]
        assert names[:4] == ["isect", "step.rng", "step.shade", "step.rng"]
        assert names[4:] == ["nee.gather", "step.shade"]
    gathers = [s for s in sp if s.name == "nee.gather"]
    assert all([c.name for c in sp if c.parent == g.id] == ["nee.anyhit"]
               for g in gathers)
    # Every span shares the sample's index and nests in time.
    assert {s.sample for s in sp} == {3}
    for s in sp:
        assert s.start_ns <= s.end_ns
        if s.parent != -1:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    own = profiling.self_ns(sp)
    assert all(v >= 0 for v in own.values())
    assert sum(own.values()) == root.end_ns - root.start_ns
    per = profiling.self_ms_per_sample(sp, 2)
    assert set(per) == {s.name for s in sp}
    assert sum(per.values()) == pytest.approx(
        (root.end_ns - root.start_ns) / 1e6 / 2)


def test_engine_spans_set_up_always_and_its_calls_when_on(rec, cornell):
    scene = cornell[0]
    cfg = RenderConfig(width=16, height=16, iterations=2, mode="fast",
                       nee=True)
    eng = RenderEngine(scene, cfg, device="cpu")
    setup = rec.spans()
    names = [s.name for s in setup]
    assert names == ["engine.init", "engine.accel", "engine.emitters",
                     "engine.rng_seed"]
    assert all(s.parent == setup[0].id for s in setup[1:])
    secs = profiling.seconds_by_name(setup)
    assert list(secs) == sorted(names)
    assert secs["engine.init"] == (setup[0].end_ns - setup[0].start_ns) / 1e9
    eng.render(1, progress=False)        # off: nothing more
    assert len(rec.spans()) == 4 and not rec.counters()
    with profiling.tracing():
        eng.render(2)                    # the meter's first tick calibrates
        eng.frame(0.0, sync=False)
        eng.display_u8()
    calls = rec.spans()[4:]
    top = [s for s in calls if s.parent == -1]
    assert [s.name for s in top] == ["engine.render", "engine.frame",
                                     "display"]
    assert [s.sample for s in top] == [1, 3, 3]
    render = top[0]
    under = collections.Counter(s.name for s in calls
                                if s.parent == render.id)
    assert under == {"step": 2, "engine.meter": 2, "engine.calibrate": 1}
    cal = [s for s in calls if s.name == "engine.calibrate"]
    assert len(cal) == 1
    disp = [s.name for s in calls if s.parent == top[2].id]
    assert disp == ["display.tonemap", "display.copy"]
    # The CPU engine waits for no device; the display's copy is counted.
    assert rec.counters() == {"host_reads.display.copy": 1}
    assert not rec.refresh()


def test_render_adaptive_reads_the_profiler(rec, cornell):
    """render_adaptive turns the recorder on under a bare torch.profiler
    and off again at its next call after the profiler has stopped."""
    cfg = RenderConfig(width=8, height=8, iterations=2, mode="fast",
                       model="wavefront")
    eng = RenderEngine(cornell[0], cfg, intersect_fn=cornell[2],
                       device="cpu")
    n = len(rec.spans())                 # the set-up spans
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        eng.render_adaptive(0.5, max_spp=1, min_spp=1, progress=False)
    on = rec.spans()[n:]
    assert on and {s.name for s in on} == {"isect"}
    eng.render_adaptive(0.5, max_spp=1, min_spp=1, progress=False)
    assert len(rec.spans()) == n + len(on) and not rec.on


def test_counters_bound_and_device_counts(monkeypatch):
    r = profiling.Recorder(max_records=4)
    monkeypatch.setattr(profiling, "RECORDER", r)
    profiling.count("a")
    assert not r.counters()
    with profiling.tracing() as on:
        assert on is r and r.on and not profiling.device_counts()
        profiling.count("a")
        profiling.count("a", 4)
        for _ in range(6):
            with profiling.span("x"):
                pass
        with profiling.tracing(device_counts=True):
            assert profiling.device_counts()
        assert not profiling.device_counts()
    assert not r.on
    assert len(r.spans()) == 4
    assert r.counters() == {"a": 5, "spans.dropped": 2}
    with profiling.span("forced", force=True):
        pass
    assert r.counters()["spans.dropped"] == 3
    r.reset()
    assert r.spans() == [] and r.counters() == {}


@pytest.mark.parametrize("device_counts", [False, True])
def test_pair_schedule_counts_its_host_reads(rec, device_counts):
    ps = library.stress_scene(1200)
    fn = si.make_pair_intersect(ps.tris, **dict(si.PAIR_TPU_WINNER,
                                               cluster_size=128, trp=128))
    cam = library.cornell_camera(16, 16)
    ids = raygen.pixel_ids_like(256)
    half = torch.full((256,), 0.5)
    rays = raygen.camera_rays(cam, ids, half, half)
    with profiling.tracing(device_counts=device_counts):
        fn(rays)
    c = rec.counters()
    assert c["isect.calls"] == 1 and c["isect.rays"] == 256
    assert c["host_reads.isect.tail"] == c["isect.tail_iterations"] + 1
    assert c["isect.escalations"] >= 1
    assert ("isect.round1_resolved" in c) is device_counts
    names = collections.Counter(s.name for s in rec.spans())
    assert names["isect.round1"] == 1
    assert names["isect.escalate"] == c["isect.escalations"]
    assert names["isect.host_read"] == sum(
        n for k, n in c.items() if k.startswith("host_reads."))


def test_span_brackets_record_function_on_the_profiler_clock(rec):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.refresh()
        with profiling.span("outer"):
            with torch.profiler.record_function("inner"):
                torch.ones(64).add_(1.0)
    assert not profiling.refresh()
    (outer,) = rec.spans()
    inner = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "inner"]
    assert len(inner) == 1
    s, e = inner[0].start_ns(), inner[0].start_ns() + inner[0].duration_ns()
    assert outer.start_ns <= s <= e <= outer.end_ns


def test_trace_profile_writes_the_spans(rec, cornell, tmp_path):
    cfg = RenderConfig(width=16, height=16, iterations=2, mode="fast")
    eng = RenderEngine(cornell[0], cfg, intersect_fn=cornell[2],
                       device="cpu")
    with profiling.trace_profile(str(tmp_path)):
        eng.render(1, progress=False)
    (path,) = glob.glob(os.path.join(tmp_path, "trace_*.json"))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    mine = [e for e in events if e.get("pid") == profiling.SPAN_PID
            and e.get("ph") == "X"]
    names = collections.Counter(e["name"] for e in mine)
    assert names["engine.render"] == 1 and names["step.bounce"] == 2
    # On the trace's own clock: inside the profiler's host events.
    aten = [e for e in events if e.get("ph") == "X"
            and e.get("name", "").startswith("aten::")]
    fold = [e for e in mine if e["name"] == "step.fold"][0]
    inside = [e for e in aten if fold["ts"] <= e["ts"]
              and e["ts"] + e["dur"] <= fold["ts"] + fold["dur"]]
    assert inside and len(inside) < len(aten)
