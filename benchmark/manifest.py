"""BENCHMARK.json and the files it names, found by name.

Each configuration is `configs/<config>.json`, each traffic mix
`traffic/<traffic>.json`, each per-layer metric `metrics/<metric>.py`
(a module with `read(trace)`), and each cell's output check
`checks/<workload>.json` (the pixels it samples and the limit of each
number compared). A cell added as these files and one manifest entry
runs without an edit to any existing file.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad name {name!r}: 1 to 64 of A-Z a-z 0-9 _ . - "
                         "starting with a letter, digit or _")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT.match(unit):
        raise ValueError(f"bad unit {unit!r}")
    return unit


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Manifest:
    """The parsed BENCHMARK.json, with lookups by name."""

    def __init__(self, data: dict, root: pathlib.Path = ROOT,
                 here: pathlib.Path = HERE) -> None:
        self.data, self.root, self.here = data, root, here
        for c in data["configs"]:
            check_name(c["name"])
        for w in data["workloads"]:
            for k in ("name", "config", "traffic"):
                check_name(w[k])
        for m in data["end_to_end"] + data["per_layer"]:
            check_name(m["name"])
            check_unit(m["unit"])

    @classmethod
    def load(cls, root: pathlib.Path = ROOT) -> "Manifest":
        return cls(_load_json(root / "BENCHMARK.json"), root)

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return _load_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _load_json(self.here / "traffic" / f"{check_name(name)}.json")

    def checks(self, workload: str) -> dict:
        return _load_json(self.here / "checks" / f"{check_name(workload)}.json")

    def _of(self, metrics: list, workload: str) -> list:
        e2e = {m["name"] for m in self.end_to_end(workload)}
        out = []
        for m in metrics:
            listed = m.get("workloads")
            if listed is not None:
                if workload in listed:
                    out.append(m)
            elif m["moves"] in e2e:
                out.append(m)
        return out

    def end_to_end(self, workload: str) -> list:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.data["end_to_end"]
                if m.get("workloads") is None or workload in m["workloads"]]

    def per_layer(self, workload: str) -> list:
        """The per-layer metrics this cell reports."""
        return self._of(self.data["per_layer"], workload)

    def reader(self, metric: str):
        """metrics/<metric>.py's read(trace) -> number or None."""
        path = self.here / "metrics" / f"{check_name(metric)}.py"
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
