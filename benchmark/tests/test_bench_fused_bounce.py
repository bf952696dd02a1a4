"""`metrics/fused_bounce_share.py` on synthetic counters: the share of
the megakernel's bounces through the bounce kernel, and None where the
program counts no bounce (a program without the kernel, or without a
recorder)."""

import sys
import types

import pytest

from benchmark import trace
from benchmark.manifest import Manifest

PROFILING = "opencl_path_tracer_tpu_torch.utils.profiling"


def make(loop="offline"):
    return trace.Trace(
        loop=loop, samples=4, wall_plain_s=0.001, window_s=0.002,
        busy_s=0.0006, launches=5, spans=trace.Spans(device=[], host=[]),
        isect_ms=0.5, isect_rays=8, isect_calls=2, anyhit_ms=0.0,
        anyhit_calls=0, rays=40.0, rays_samples=8, display_ms=[],
        device="cuda")


def read(t):
    return Manifest.load().reader("fused_bounce_share")(t)


def with_counters(monkeypatch, counters):
    from benchmark import recorder
    mod = types.SimpleNamespace(spans=lambda: [], counters=lambda: counters)
    monkeypatch.setattr(recorder, "_recorder", lambda: mod)


@pytest.mark.parametrize("fused, plain, share", [
    (20, 0, 1.0), (0, 20, 0.0), (15, 5, 0.75)])
def test_share_of_fused_bounces(monkeypatch, fused, plain, share):
    counters = {"isect.calls": 20, "host_reads.engine.sync": 1}
    if fused:
        counters["step.bounces.fused"] = fused
    if plain:
        counters["step.bounces.plain"] = plain
    with_counters(monkeypatch, counters)
    assert read(make()) == pytest.approx(share)
    assert read(make("interactive")) is None


@pytest.mark.parametrize("absent", ["no module", "no recorder",
                                    "no bounce counters"])
def test_none_without_bounce_counters(monkeypatch, absent):
    if absent == "no module":
        monkeypatch.setitem(sys.modules, PROFILING, None)
    elif absent == "no recorder":
        monkeypatch.setitem(sys.modules, PROFILING,
                            types.ModuleType(PROFILING))
    else:
        with_counters(monkeypatch, {"isect.calls": 20})
    assert read(make()) is None
