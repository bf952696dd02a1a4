"""The traced run's arithmetic on synthetic spans and event intervals."""

import pytest

from benchmark import peaks, trace
from benchmark.manifest import Manifest


def spans():
    # Device spans in microseconds: two overlapping, then a gap.
    dev = [("k1", 0.0, 100.0), ("k2", 50.0, 150.0), ("k1", 300.0, 400.0),
           ("k3", 1000.0, 1100.0)]
    host = [("render", -10.0, 1200.0), ("intersect", 140.0, 320.0)]
    return trace.Spans(device=dev, host=host)


def make(**kw):
    base = dict(loop="offline", samples=4, wall_plain_s=0.001,
                window_s=0.002, busy_s=0.00035, launches=4, spans=spans(),
                isect_ms=0.5, isect_rays=8_000_000, isect_calls=20,
                anyhit_ms=0.2, anyhit_calls=16, rays=40_000_000.0,
                rays_samples=8, display_ms=[1.0, 3.0, 2.0],
                device="cuda")
    base.update(kw)
    return trace.Trace(**base)


def test_busy_is_the_union():
    assert trace.busy_s(spans()) == pytest.approx(350e-6)


def test_idle_gaps_named_by_innermost_range():
    gaps = trace.idle_gaps(spans())
    assert gaps[0] == ["render", pytest.approx(600e-6)]
    assert gaps[1] == ["intersect", pytest.approx(150e-6)]


def test_top_ops():
    ops = trace.top_ops(spans())
    assert ops[0] == ["k1", pytest.approx(200e-6)]
    assert {n for n, _ in ops} == {"k1", "k2", "k3"}


def read(name, t):
    return Manifest.load().reader(name)(t)


def test_readers_offline():
    t = make()
    assert read("device_idle_pct.offline", t) == pytest.approx(65.0)
    assert read("device_idle_pct.interactive", t) is None
    assert read("launches_per_sample", t) == pytest.approx(1.0)
    assert read("rays_per_sample", t) == pytest.approx(5e6)
    assert read("isect_ms_per_sample", t) == pytest.approx(0.125)
    assert read("anyhit_ms_per_sample", t) == pytest.approx(0.05)
    floor = 8e6 * 56 / 3.35e12
    assert read("isect_roofline", t) == pytest.approx(100 * floor / 5e-4)
    assert read("step_mfu", t) == pytest.approx(
        100 * 8e6 * 12 / (0.001 * 67e12))
    assert read("display_ms_p50", t) is None


def test_readers_interactive():
    t = make(loop="interactive", isect_calls=0, anyhit_calls=0)
    assert read("device_idle_pct.interactive", t) == pytest.approx(65.0)
    assert read("display_ms_p50", t) == pytest.approx(2.0)
    for name in ("device_idle_pct.offline", "launches_per_sample",
                 "isect_ms_per_sample", "anyhit_ms_per_sample"):
        assert read(name, t) is None


def test_readers_find_nothing_on_the_cpu():
    t = make(device="cpu")
    for name in ("device_idle_pct.offline", "launches_per_sample",
                 "isect_ms_per_sample", "isect_roofline", "step_mfu",
                 "anyhit_ms_per_sample"):
        assert read(name, t) is None


def test_floor_is_bound_by_bytes():
    assert peaks.isect_floor_s(1000) == pytest.approx(1000 * 56 / 3.35e12)
    assert 1000 * 56 / 3.35e12 > 1000 * 12 / 67e12


def test_call_log_counts_rays():
    import torch

    class R:
        count = 5

    log = trace.CallLog(lambda r: 1, "intersect", torch.device("cpu"))
    assert log(R()) == 1
    log(R())
    assert log.rays == 10 and len(log.pairs) == 2 and log.total_ms() >= 0
    log.reset()
    assert log.rays == 0 and not log.pairs
