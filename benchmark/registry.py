"""Finds what `BENCHMARK.json` names, by name, in the benchmark's folders:

  * configs/<config>.json  a model configuration (the file the entry names);
  * traffic/<mix>.json     a traffic mix: the parameters that one module
                           reads, `kind` naming it (drive_<kind>.py);
  * metrics/<metric>.py    a per-layer metric's reader, `read(reading)`;
  * limits/<cell>.json     the limits of the numbers a cell's check compares.

A new configuration, mix, metric or cell is a new file and a new entry;
nothing here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Bench:
    def __init__(self, root: str = ROOT, folder: str = HERE):
        self.root = root
        self.folder = folder
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def cell(self, name: str) -> Dict[str, Any]:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict[str, Any]:
        for c in self.spec["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> Dict[str, Any]:
        with open(os.path.join(self.folder, "traffic", name + ".json")) as f:
            return json.load(f)

    def limits(self, cell: str) -> Dict[str, Any]:
        path = os.path.join(self.folder, "limits", cell + ".json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    def _applies(self, metric: Dict[str, Any], cell: str, end_to_end: List[str]) -> bool:
        if "workloads" in metric:
            return cell in metric["workloads"]
        return metric.get("moves") is None or metric["moves"] in end_to_end

    def end_to_end(self, cell: str) -> List[Dict[str, Any]]:
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> List[Dict[str, Any]]:
        names = [m["name"] for m in self.end_to_end(cell)]
        return [m for m in self.spec["per_layer"] if self._applies(m, cell, names)]

    def reader(self, metric: str):
        """The `read` function of metrics/<metric>.py."""
        path = os.path.join(self.folder, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def kind_module(kind: str):
    """The module that runs a mix of `kind` (drive_<kind>.py)."""
    return importlib.import_module(f"benchmark.drive_{kind}")

