"""Device idle time put down to the program's spans (`attribution.py`),
and the readers of the program's recorder (`recorder.py`,
`metrics/*_idle_*`, `host_reads_per_sample`, `engine_build_s`,
`scene_build_s`) on
synthetic spans and counters, with and without a recorder."""

import ast
import pathlib
import random
import subprocess
import sys
import types

import pytest

from benchmark import attribution, trace
from benchmark.manifest import Manifest

HERE = pathlib.Path(__file__).resolve().parents[1]
PORT = "opencl_path_tracer_tpu_torch"
PROFILING = PORT + ".utils.profiling"
NEW = ["step_idle_ms_per_sample", "isect_idle_ms_per_sample",
       "nee_idle_ms_per_sample", "step_idle_ms_per_frame",
       "display_idle_ms_per_frame", "host_reads_per_sample",
       "engine_build_s", "scene_build_s"]

# Device spans (µs): busy 0-10, 20-30, 30-40 (merged), 45-50, 70-80, so
# gaps 10-20, 40-45, 50-70.
DEVICE = [("k", 0.0, 10.0), ("k", 20.0, 30.0), ("k", 25.0, 40.0),
          ("k", 45.0, 50.0), ("k", 70.0, 80.0)]
# Program spans, on the device's clock: the gap at 10 begins under
# step.shade, the one at 40 under isect.host_read (inside isect), the
# one at 50 under engine.render alone; the last read, engine.sync, ends
# with the last device span.
PROGRAM = [("engine.render", 0.0, 80.0), ("step", 1.0, 45.0),
           ("step.bounce", 2.0, 44.0), ("step.shade", 5.0, 15.0),
           ("isect", 30.0, 43.0), ("isect.host_read", 39.0, 41.0),
           ("engine.sync", 75.0, 80.0)]


def make(**kw):
    base = dict(loop="offline", samples=4, wall_plain_s=0.001,
                window_s=0.002, busy_s=0.0006, launches=5,
                spans=trace.Spans(device=DEVICE, host=[]), isect_ms=0.5,
                isect_rays=8, isect_calls=2, anyhit_ms=0.0, anyhit_calls=0,
                rays=40.0, rays_samples=8, display_ms=[], device="cuda")
    base.update(kw)
    return trace.Trace(**base)


def test_gaps_are_every_gap_between_merged_spans():
    assert attribution.gaps(DEVICE) == [(10.0, 20.0), (40.0, 45.0),
                                        (50.0, 70.0)]


def test_innermost_span_names_each_time():
    names = attribution.innermost(PROGRAM, [0.5, 10.0, 40.0, 50.0, 77.0,
                                            95.0])
    assert names == ["engine.render", "step.shade", "isect.host_read",
                     "engine.render", "engine.sync", None]


@pytest.mark.parametrize("name,layer", [
    ("step", "model step"), ("step.fold", "model step"),
    ("isect", "intersect"), ("isect.host_read", "intersect"),
    ("nee.anyhit", "NEE"), ("display.copy", "display"),
    ("engine.meter", "engine"), ("scene.build", "outside"),
    (None, "outside")])
def test_layer_of(name, layer):
    assert attribution.layer_of(name) == layer


def test_layers_ms_from_synthetic_spans():
    by = attribution.idle_by_layer(DEVICE, PROGRAM)
    assert by == {"model step": 10.0, "intersect": 5.0, "NEE": 0.0,
                  "display": 0.0, "engine": 20.0, "outside": 0.0}
    # Plain idle: (1 ms - 0.6 ms) / 4 samples = 0.1 ms a sample.
    ms = attribution.layer_ms(DEVICE, PROGRAM, 0.001, 0.0006, 4)
    assert ms["model step"] == pytest.approx(0.1 * 10 / 35)
    assert ms["intersect"] == pytest.approx(0.1 * 5 / 35)
    assert ms["engine"] == pytest.approx(0.1 * 20 / 35)


@pytest.mark.parametrize("program", [PROGRAM, PROGRAM[1:], []])
def test_layers_and_outside_sum_to_the_plain_idle(program):
    ms = attribution.layer_ms(DEVICE, program, 0.0013, 0.0004, 3)
    assert sum(ms.values()) == pytest.approx(
        attribution.plain_idle_ms(0.0013, 0.0004, 3))
    if not program:
        assert ms["outside"] == pytest.approx(0.3)


def _waited_phase(seed=3):
    """Irregular device spans (busy 5-40 µs, idle 1-12 µs) and a program
    whose 30 blocking reads return 0.5 µs after a device span ends, on
    the device's clock."""
    rs = random.Random(seed)
    device, t = [], 0.0
    for _ in range(400):
        d = rs.uniform(5.0, 40.0)
        device.append(("k", t, t + d))
        t += d + rs.uniform(1.0, 12.0)
    program = [("engine.render", -5.0, t + 5.0)]
    for k in range(10, 400, 13):
        end = device[k][2] + 0.5
        program.append(("isect.host_read", end - 20.0, end))
    return device, program


@pytest.mark.parametrize("off", [-430.0, -35.0, 0.0, 80.0, 390.0])
def test_align_finds_the_offset_the_reads_allow(off):
    """Program spans on a clock `off` µs from the device's: the offset at
    which no read returns while the device is busy is recovered to the
    reads' 0.5 µs latency."""
    device, program = _waited_phase()
    shifted = [(n, s + off, e + off) for n, s, e in program]
    back = attribution.align(device, shifted)
    for a, b in zip(back, program):
        assert a[0] == b[0] and a[1] == pytest.approx(b[1], abs=1.5)


def test_align_keeps_a_clock_the_reads_allow():
    """No read contradicts the clocks (PROGRAM's reads fall in gaps): no
    shift. No read, or no device span: no shift."""
    assert attribution.align(DEVICE, PROGRAM) == PROGRAM
    no_read = [p for p in PROGRAM if p[0] not in attribution.READS]
    assert attribution.align(DEVICE, no_read) == no_read
    assert attribution.align([], PROGRAM) == PROGRAM
    # The device seems to run on after the final synchronise returned:
    # the least shift that lets it finish first.
    late = [(n, s - 4.0, e - 4.0) for n, s, e in PROGRAM]
    back = attribution.align(DEVICE, late)
    assert back[-1][2] == pytest.approx(80.0)


def test_no_gap_reads_nothing():
    assert attribution.layer_ms([("k", 0.0, 5.0)], PROGRAM, 1.0, 0.5,
                                1) is None


def read(name, t):
    return Manifest.load().reader(name)(t)


@pytest.fixture
def fake_recorder(monkeypatch):
    """A program recorder holding PROGRAM (µs -> ns), engine set-up spans
    and counters."""
    from benchmark import recorder

    class S:
        def __init__(self, name, s_us, e_us):
            self.name, self.start_ns, self.end_ns = name, s_us * 1e3, e_us * 1e3

    spans = [S(*p) for p in PROGRAM] + [
        S("engine.init", -5e6, -3e6), S("engine.init", -2e6, -1.5e6),
        S("engine.calibrate", -1e6, -0.75e6),
        S("scene.build", -8e6, -6e6), S("scene.build", -5.5e6, -5.25e6)]
    mod = types.SimpleNamespace(
        spans=lambda: spans,
        counters=lambda: {"host_reads.engine.sync": 1,
                          "host_reads.isect.tail": 7, "isect.calls": 5})
    monkeypatch.setattr(recorder, "_recorder", lambda: mod)
    return mod


def test_readers_with_a_recorder(fake_recorder):
    t = make()
    assert read("step_idle_ms_per_sample", t) == pytest.approx(0.1 * 10 / 35)
    assert read("isect_idle_ms_per_sample", t) == pytest.approx(0.1 * 5 / 35)
    assert read("nee_idle_ms_per_sample", t) == 0.0
    assert read("host_reads_per_sample", t) == pytest.approx(8 / 4)
    assert read("engine_build_s", t) == pytest.approx(0.5 + 0.25)
    assert read("scene_build_s", t) == pytest.approx(0.25)
    for name in ("step_idle_ms_per_frame", "display_idle_ms_per_frame"):
        assert read(name, t) is None
    ti = make(loop="interactive", samples=2)
    assert read("step_idle_ms_per_frame", ti) == pytest.approx(
        0.2 * 10 / 35)
    assert read("display_idle_ms_per_frame", ti) == 0.0
    assert read("host_reads_per_sample", ti) is None
    # No device spans (a CPU run): no idle is put down.
    tc = make(device="cpu")
    assert read("step_idle_ms_per_sample", tc) is None


@pytest.mark.parametrize("absent", ["no module", "no recorder"])
@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_without_a_recorder(name, absent,
                                                 monkeypatch):
    """The parent's program has no recorder (its profiling module lacks
    spans and counters), or none at all: every new reader gives None."""
    if absent == "no module":
        monkeypatch.setitem(sys.modules, PROFILING, None)
    else:
        monkeypatch.setitem(sys.modules, PROFILING, types.ModuleType(
            PROFILING))
    for t in (make(), make(loop="interactive", samples=2)):
        assert read(name, t) is None


def _imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


def test_attribution_imports_nothing_of_the_port():
    assert not any(m.split(".")[0] in (PORT, "jax", "opencl_path_tracer_tpu")
                   for m in _imports(HERE / "attribution.py"))
    code = ("import sys, benchmark.attribution; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         text=True, capture_output=True, check=True).stdout
    assert PORT not in out and "'jax'" not in out
