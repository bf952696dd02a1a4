"""The manifest and the files it names, by name; a cell added as files."""

import json
import pathlib
import shutil

import pytest

from benchmark import manifest, run
from benchmark.manifest import Manifest, check_name, check_unit

ROOT = pathlib.Path(__file__).resolve().parents[2]
SMALL = dict(width=16, height=16, pixels=256, spp_per_call=2, trace_spp=2,
             trace_frames=2)


def test_every_cell_finds_its_files():
    man = Manifest.load()
    for w in man.data["workloads"]:
        assert man.config(w["config"])["name"] == w["config"]
        assert man.traffic(w["traffic"])["loop"] in ("offline", "interactive")
        assert man.checks(w["name"])["limits"]
        assert man.end_to_end(w["name"]), w["name"]
        assert any(m["name"] == "setup_s" for m in man.end_to_end(w["name"]))
        layer = man.per_layer(w["name"])
        assert layer, w["name"]
        for m in layer:
            assert callable(man.reader(m["name"]))
            assert m["moves"] in {e["name"] for e in man.end_to_end(w["name"])}


def test_contract_shape():
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(data) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    for c in data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in data["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in data["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in data["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    names = [m["name"] for m in data["end_to_end"] + data["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("good", ["setup_s", "device_idle_pct.offline",
                                  "cornell-box", "_x", "9a"])
def test_names_allowed(good):
    assert check_name(good) == good


@pytest.mark.parametrize("bad", ["", "a b", "a/b", "a,b", "-x", ".x",
                                 "x" * 65, "µs"])
def test_names_refused(bad):
    with pytest.raises(ValueError):
        check_name(bad)


@pytest.mark.parametrize("unit,ok", [("samples/s", True), ("%", True),
                                     ("ms", True), ("frames per s", False),
                                     ("µs", False), ("", False)])
def test_units(unit, ok):
    if ok:
        assert check_unit(unit) == unit
    else:
        with pytest.raises(ValueError):
            check_unit(unit)


def test_every_manifest_name_and_unit_is_allowed():
    Manifest.load()     # raises on a bad name or unit


def test_cell_added_as_files_runs(tmp_path):
    """A new cell made of a traffic file, a checks file and one manifest
    entry (over an existing configuration) runs with no edit to any
    existing file."""
    here = tmp_path / "benchmark"
    for d in ("configs", "traffic", "checks", "metrics"):
        shutil.copytree(manifest.HERE / d, here / d)
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    (here / "traffic" / "offline-spp4.json").write_text(json.dumps(
        {"loop": "offline", "spp_per_call": 4, "trace_spp": 2,
         "render": {}}))
    (here / "checks" / "cornell-offline-spp4.json").write_text(json.dumps(
        {"pixels": 256, "limits": {"image_rel_mae": 1e-3,
                                   "nonfinite_pixels": 0,
                                   "sample_count_error": 0}}))
    data["workloads"].append({"name": "cornell-offline-spp4",
                              "config": "cornell-box",
                              "traffic": "offline-spp4", "chips": 1,
                              "why": "test"})
    for m in data["end_to_end"] + data["per_layer"]:
        if "samples_per_s" in (m["name"], m.get("moves")) and "workloads" in m:
            m["workloads"].append("cornell-offline-spp4")
    for m in data["end_to_end"]:
        if m["name"] == "samples_per_s":
            m["workloads"].append("cornell-offline-spp4")
    man = Manifest(data, root=tmp_path, here=here)
    for c in data["configs"]:
        dst = tmp_path / c["file"]
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ROOT / c["file"], dst)
    res = run.run_cell("cornell-offline-spp4", 7, 0.1, False, device="cpu",
                       overrides=SMALL, manifest=man)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"samples_per_s", "setup_s"}


def test_tiled_cell_entries():
    """The four-card cell: its configuration renders over as many ranks
    as the cell asks for chips, its traffic asks for the frame after each
    call, and it reports the mesh readers but not the idle attribution
    (whose clock fit is per process) nor rank 0's device idle (whose busy
    time holds NCCL's waiting kernels)."""
    man = Manifest.load()
    w = man.workload("cornell-tiled-4chip")
    cfg = man.config(w["config"])
    assert w["chips"] == 4 == cfg["devices"]
    assert (cfg["width"], cfg["height"]) == (3840, 2160)
    assert cfg["reduced"] == [] and cfg["mode"] == "fast"
    traffic = man.traffic(w["traffic"])
    assert traffic["image_every_call"] is True
    assert traffic["spp_per_call"] == 64 and traffic["trace_spp"] == 32
    assert man.checks(w["name"])["pixels"] == 4096
    layer = {m["name"] for m in man.per_layer(w["name"])}
    assert {"gather_ms_per_call", "rank_imbalance",
            "allgather_busbw_share", "launches_per_sample",
            "rays_per_sample"} <= layer
    assert not {n for n in layer if "_idle_ms_" in n}
    assert "device_idle_pct.offline" not in layer
    assert {m["name"] for m in man.end_to_end(w["name"])} == {
        "samples_per_s", "setup_s"}
    four = [c for c in man.data["workloads"] if c["chips"] == 4]
    assert len(four) <= max(1, len(man.data["workloads"]) // 4)
