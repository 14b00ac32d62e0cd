"""A cell of ``BENCHMARK.json`` and its files, found by name.

For the cell named ``<traffic>.<config>`` in ``workloads``:

* the configuration: the file its ``configs`` entry names;
* the traffic: ``portbench/traffic/<traffic>.json``, whose ``driver``
  names a module of ``portbench/drivers/``;
* each per-layer metric the cell reports: ``portbench/metrics/<metric>.py``,
  a ``read(reading)`` that returns the number or None;
* the limits of its outputs: ``portbench/limits/<cell>.json``.

Adding a cell, a traffic mix or a metric is adding those files and an
entry in ``BENCHMARK.json``; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import Callable, Dict, List

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


class Cell:
    def __init__(self, name: str, root: pathlib.Path = ROOT):
        spec = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json; have "
                           f"{sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads(
            (root / self.config_entry["file"]).read_text())
        self.traffic = json.loads(
            (BENCH / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.end_to_end: List[dict] = [
            m for m in spec["end_to_end"]
            if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer: List[dict] = [
            m for m in spec["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]
        limits = BENCH / "limits" / f"{name}.json"
        self.limits: Dict[str, float] = (json.loads(limits.read_text())
                                         if limits.exists() else {})
        self._readers: Dict[str, Callable] = {}

    def unit(self, metric: str) -> str:
        for m in self.end_to_end + self.per_layer:
            if m["name"] == metric:
                return m["unit"]
        raise KeyError(f"cell {self.name} reports no metric {metric!r}")

    def reader(self, metric: str) -> Callable:
        """``read`` of ``portbench/metrics/<metric>.py``."""
        if metric not in self._readers:
            path = BENCH / "metrics" / f"{metric}.py"
            spec = importlib.util.spec_from_file_location(
                f"portbench_metric_{len(self._readers)}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._readers[metric] = mod.read
        return self._readers[metric]
