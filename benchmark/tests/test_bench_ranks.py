"""The multi-rank path (`ranks.py`): two gloo ranks on the CPU at 32 x 16.

The cell `cornell-tiled-4chip` runs as one process a rank; here two
ranks split the frame into two bands. The run is correct against the
tile-keyed reference; band 0, keyed as the whole frame is on one device,
is bit-equal to the one-process run, and in parity mode (per-pixel
Lehmer streams, no tile key) the whole frame is. Planted inside the
ranks (`rank_fn`), each fault a tiled cell can have fails the check:
every rank keyed at tile 0, the frame's exchange between ranks left
out, a step that returns its state, half the pixels left out, each
sample's radiance altered. A rank that raises fails the run before any
result line. The mesh readers are held to known values on synthetic
summaries.
"""

import functools
import json
import shutil

import numpy as np
import pytest
import torch

from benchmark import manifest, ranks, run, trace
from benchmark.manifest import Manifest
from test_bench_control import _altered, _half, _stale

CELL = "cornell-tiled-4chip"
SMALL = dict(width=32, height=16, pixels=512, spp_per_call=2, trace_spp=2,
             devices=2)
SEED = 424242


def _spy(monkeypatch):
    """The program colours handed to the reference, in call order."""
    got = []
    real = run.reference_readings

    def spy(*args, **kw):
        got.append(np.array(args[7]))
        return real(*args, **kw)

    monkeypatch.setattr(run, "reference_readings", spy)
    return got


def _with_fault(fault, job):
    """A rank of rank_cell with a fault planted in its own process."""
    from opencl_path_tracer_tpu_torch.models import megakernel
    from opencl_path_tracer_tpu_torch.parallel import shard
    from opencl_path_tracer_tpu_torch.runtime import engine
    import torch.distributed as dist
    if fault == "tile0":
        build = engine.RenderEngine._build

        def keyed_at_zero(self, *a):
            build(self, *a)
            self._tile0 = 0
        engine.RenderEngine._build = keyed_at_zero
    elif fault == "no_exchange":
        shard.all_gather_lanes = lambda x, mesh: torch.cat([x] * mesh.size())
    elif fault == "raise":
        if dist.get_rank() == 1:
            raise RuntimeError("planted: rank 1 fails")
    else:
        step = {"stale": _stale, "half": _half, "altered": _altered}[fault]
        megakernel.trace_sample = step(megakernel.trace_sample)
    return ranks.rank_cell(job)


def test_two_ranks_correct_band0_bit_equal(monkeypatch):
    got = _spy(monkeypatch)
    two = run.run_cell(CELL, SEED, 0.0, False, device="cpu",
                       overrides=SMALL)
    one = run.run_cell(CELL, SEED, 0.0, False, device="cpu",
                       overrides=dict(SMALL, devices=1))
    assert two["correct"], two["checks"]
    assert one["correct"], one["checks"]
    assert two["ranks"] == 2 and "ranks" not in one
    assert set(two["metrics"]) == {"samples_per_s", "setup_s"}
    assert two["samples"] == one["samples"] == 3
    band0 = slice(0, 256)               # pixel ids 0..255, keyed at 0
    assert np.array_equal(got[0][band0], got[1][band0])
    assert not np.array_equal(got[0][256:], got[1][256:])


def test_parity_two_ranks_bit_equal_to_one(tmp_path, monkeypatch):
    """Parity mode keys no tile: the harness's two-rank frame is the
    one-process frame to the bit, at every checked pixel."""
    here = tmp_path / "benchmark"
    for d in ("configs", "traffic", "checks", "metrics"):
        shutil.copytree(manifest.HERE / d, here / d)
    data = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((manifest.HERE / "configs" / "cornell-4k.json")
                     .read_text())
    (here / "configs" / "cornell-4k.json").write_text(
        json.dumps(dict(cfg, mode="parity")))
    man = Manifest(data, root=tmp_path, here=here)
    got = _spy(monkeypatch)
    kw = dict(device="cpu", manifest=man)
    two = run.run_cell(CELL, SEED, 0.0, False,
                       overrides=dict(SMALL, spp_per_call=3), **kw)
    one = run.run_cell(CELL, SEED, 0.0, False, **kw,
                       overrides=dict(SMALL, spp_per_call=3, devices=1))
    assert two["samples"] == one["samples"] == 4
    assert np.array_equal(got[0], got[1])


def test_traced_two_ranks_line():
    res = run.run_cell(CELL, SEED, 0.0, True, device="cpu", overrides=SMALL)
    assert res["correct"], res["checks"]
    line = run.result_line(res, res["ranks"], True, "cpu")
    assert line["device"]["count"] == 2
    assert line["device"]["window_s"] > 0
    assert list(line)[-1] == "checks"
    m = res["metrics"]
    assert m["gather_ms_per_call"]["value"] > 0
    # Device readers find nothing to read on the CPU.
    assert "rank_imbalance" not in m and "allgather_busbw_share" not in m
    assert m["rays_per_sample"]["value"] > 0


def test_ranks_merge_sums_and_maxima(monkeypatch):
    from benchmark import program

    def fake(fn, world, args, device):
        return [dict(rank=k, forbidden=["jax"] if k else [],
                     seeds=[dict(setup_s=1.0 + k, memory_peak_bytes=10 - k,
                                 busy_s=0.5 + k, window_s=2.0 + k,
                                 colors=np.zeros((1, 3)) if k == 0 else None,
                                 accel="a", asked=3, samples=3, units=1)])
                for k in range(world)]

    monkeypatch.setattr(program, "launch", fake)
    (res,), bad = ranks.run({}, 2, "cpu")
    assert res["setup_s"] == 2.0 and res["memory_peak_bytes"] == 10
    assert res["busy_s"] == pytest.approx(2.0)
    assert res["window_s"] == pytest.approx(5.0)
    assert res["colors"] is not None and bad == ["jax"]


@pytest.mark.parametrize("fault,fails", [
    ("tile0", "image_rel_mae"), ("no_exchange", "image_rel_mae"),
    ("stale", "sample_count_error"), ("half", "image_rel_mae"),
    ("altered", "image_rel_mae")])
def test_fault_fails(fault, fails):
    res = run.run_cell(CELL, SEED, 0.2, False, device="cpu", overrides=SMALL,
                       rank_fn=functools.partial(_with_fault, fault))
    assert not res["correct"]
    c = res["checks"][fails]
    assert c["value"] > c["limit"], res["checks"]


def test_rank_that_raises_fails_the_run(monkeypatch, capsys):
    real = run.run_cell

    def on_cpu(workload, seed, seconds, trace, manifest=None):
        return real(workload, seed, seconds, trace, device="cpu",
                    overrides=SMALL, manifest=manifest,
                    rank_fn=functools.partial(_with_fault, "raise"))

    monkeypatch.setattr(run, "run_cell", on_cpu)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(Exception, match="planted: rank 1 fails"):
        run.main(["--workload", CELL, "--seed", "3000000000", "--seconds",
                  "0.1", "--trace", "0"])
    assert capsys.readouterr().out.strip() == ""


def _summary(samples, busy, gather_s, kernels=1, images=1):
    return dict(samples=samples, compute_busy_s=busy, all_gather_s=gather_s,
                all_gather_kernels=kernels, images=images)


def _mesh_trace(ranks_, image_ms=(12.0, 18.0), pixels=3840 * 2160):
    from test_bench_metrics import make
    return make(ranks=list(ranks_), image_ms=list(image_ms),
                frame_pixels=pixels)


def read(name, t):
    return Manifest.load().reader(name)(t)


def test_gather_ms_per_call():
    assert read("gather_ms_per_call", _mesh_trace(
        [_summary(4, 1.0, 1e-3)] * 2)) == pytest.approx(15.0)
    assert read("gather_ms_per_call", _mesh_trace([])) is None


def test_rank_imbalance():
    t = _mesh_trace([_summary(4, b, 1e-3) for b in (1.0, 1.0, 1.0, 2.0)])
    assert read("rank_imbalance", t) == pytest.approx(2.0 / 1.25)
    even = _mesh_trace([_summary(4, 1.0, 1e-3)] * 4)
    assert read("rank_imbalance", even) == pytest.approx(1.0)
    assert read("rank_imbalance", _mesh_trace([])) is None


def test_allgather_busbw_share():
    from benchmark import peaks
    px = 3840 * 2160
    moved = 3 / 4 * px * 12
    at_peak = moved / peaks.NVLINK_BYTES_PER_S
    t = _mesh_trace([_summary(4, 1.0, at_peak)] * 4, pixels=px)
    assert read("allgather_busbw_share", t) == pytest.approx(100.0)
    # Two gathers in the phase at twice the time each: the same share;
    # a slower gather reads less, never more than the links' peak.
    t = _mesh_trace([_summary(4, 1.0, 2 * at_peak, 2, 2)] * 4, pixels=px)
    assert read("allgather_busbw_share", t) == pytest.approx(100.0)
    t = _mesh_trace([_summary(4, 1.0, 4 * at_peak)] * 4, pixels=px)
    assert read("allgather_busbw_share", t) == pytest.approx(25.0)
    none = _mesh_trace([_summary(4, 1.0, 0.0, kernels=0)] * 4, pixels=px)
    assert read("allgather_busbw_share", none) is None


def test_rank_summary_leaves_out_nccl():
    spans = trace.Spans(device=[
        ("k1", 0.0, 100.0),
        ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", 100.0, 400.0),
        ("ncclDevKernel_AllGather_RING_LL(x)", 500.0, 700.0),
        ("k2", 700.0, 750.0)], host=[])
    from test_bench_metrics import make
    s = trace.rank_summary(make(spans=spans, images=1))
    assert s["compute_busy_s"] == pytest.approx(150e-6)
    assert s["all_gather_s"] == pytest.approx(200e-6)
    assert s["all_gather_kernels"] == 1 and s["images"] == 1
    assert s["samples"] == 4


def test_collective_ranges_are_no_device_op():
    """torch.distributed's ranges around a collective come projected onto
    the device's timeline beside NCCL's kernel; only the kernel counts."""
    spans = trace.split([
        ("render", False, 0.0, 900.0), ("render", True, 0.0, 900.0),
        ("k1", True, 10.0, 100.0),
        ("nccl:all_reduce", True, 100.0, 400.0),
        ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", True, 100.0, 400.0),
        ("cudaLaunchKernel", False, 9.0, 11.0)])
    assert [n for n, _, _ in spans.device] == [
        "k1", "ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)"]
    assert spans.host == [("render", 0.0, 900.0)]
