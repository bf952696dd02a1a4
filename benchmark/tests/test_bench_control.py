"""The comparison rejects the control and the faults a cell can have.

The control is the plain reference put in the program's place and
computed in bfloat16, the precision below the configurations' float32
(`readings.control_readings`); on the chip it is read at each cell's own
size by `python3 -m benchmark.readings`. Here, at 16 x 16 on the CPU, it
must fail each cell's limits. The faults are planted under a whole run
with the chip check skipped (`run.run_cell` on the CPU): a step that
returns its state unchanged; half of the batch (the pixels) left out, the
average taken over the rest; an answer (each sample's radiance) altered
where it is produced. The exchange between chips, and the faults of the
tiled cell, are planted in its ranks by `test_bench_ranks.py`.
"""

import dataclasses

import pytest
import torch

from benchmark import compare, readings, reference, run, scenes
from benchmark.manifest import Manifest
from opencl_path_tracer_tpu_torch.models import megakernel

SMALL = dict(width=16, height=16, pixels=256, spp_per_call=2, trace_spp=2,
             trace_frames=2)
CELLS = ["cornell-offline", "stress-offline", "cornell-interactive",
         "cornell-nee-offline", "cornell-tiled-4chip"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    man = Manifest.load()
    w = man.workload(cell)
    cfg = man.config(w["config"])
    traffic = man.traffic(w["traffic"])
    render = {**cfg, **traffic.get("render", {}), "width": 16, "height": 16}
    arrays = scenes.build_scene(cfg)
    cam = scenes.camera(render)
    pixels = compare.check_pixels(11, 256, 256)
    dev = torch.device("cpu")
    seed = run.render_seed(11)
    ref = reference.render_pixels(reference.Scene(arrays, cam, dev), seed,
                                  pixels, 4, render["iterations"],
                                  bool(render.get("nee", False)),
                                  int(render.get("devices", 1)))
    values = readings.control_readings(arrays, cam, dev, seed, pixels, 4,
                                       render, ref,
                                       traffic["loop"] == "interactive")
    limits = man.checks(cell)["limits"]
    ok, checks = compare.judge(values, {k: limits[k] for k in values})
    assert not ok, checks
    assert values["image_rel_mae"] > 3 * limits["image_rel_mae"]


def _stale(real):
    def step(cam, mats, state, **kw):
        out = real(cam, mats, state, **kw)
        if kw.get("with_stats"):
            return state, out[1]
        return state
    return step


def _half(real):
    def step(cam, mats, state, **kw):
        out = real(cam, mats, state, **kw)
        new = out[0] if kw.get("with_stats") else out
        n = new.colors[0].shape[0] // 2
        cols = tuple(torch.cat([c[:n], o[n:]])
                     for c, o in zip(new.colors, state.colors))
        new = dataclasses.replace(new, colors=cols)
        return (new, out[1]) if kw.get("with_stats") else new
    return step


def _altered(real):
    def step(cam, mats, state, **kw):
        out = real(cam, mats, state, **kw)
        new = out[0] if kw.get("with_stats") else out
        s = float(state.sample)
        cols = tuple((o * s + 1.25 * (c * (s + 1.0) - o * s)) / (s + 1.0)
                     for c, o in zip(new.colors, state.colors))
        new = dataclasses.replace(new, colors=cols)
        return (new, out[1]) if kw.get("with_stats") else new
    return step


@pytest.mark.parametrize("cell", ["cornell-offline", "cornell-interactive",
                                  "cornell-nee-offline"])
@pytest.mark.parametrize("fault,fails", [
    (_stale, "sample_count_error"), (_half, "image_rel_mae"),
    (_altered, "image_rel_mae")])
def test_fault_fails(monkeypatch, cell, fault, fails):
    monkeypatch.setattr(megakernel, "trace_sample",
                        fault(megakernel.trace_sample))
    res = run.run_cell(cell, 424242, 0.05, False, device="cpu",
                       overrides=SMALL)
    assert not res["correct"]
    c = res["checks"][fails]
    assert c["value"] > c["limit"], res["checks"]
