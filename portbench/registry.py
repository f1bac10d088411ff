"""Finds the benchmark's pieces by the names BENCHMARK.json gives them.

  * a cell                — an entry of `workloads` in BENCHMARK.json;
  * a configuration       — the JSON file its `configs` entry names;
  * a traffic mix         — portbench/traffic/<traffic>.json;
  * a generator           — portbench/gen/<generator>.py, named by the
                            configuration's "generator", with a
                            make(cfg, batch, seed, device) function;
  * a metric              — portbench/metrics/<metric>.py, with a
                            read(run) function that returns a number or
                            None when the run holds nothing to read.

A new cell, configuration, traffic mix or metric is a new file and a new
entry of BENCHMARK.json; no file here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def benchmark(root=ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root=ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as fh:
                return json.load(fh)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, pkg=PKG) -> dict:
    with open(os.path.join(pkg, "traffic", name + ".json")) as fh:
        return json.load(fh)


def _module(kind: str, name: str, pkg=PKG):
    """<pkg>/<kind>/<name>.py, loaded by its path (a metric's name may hold
    dots)."""
    path = os.path.join(pkg, kind, name + ".py")
    key = f"portbench.{kind}.{name}" if pkg == PKG else f"portbench.{kind}.{name}@{pkg}"
    mod = sys.modules.get(key)
    if mod is None:
        if not os.path.isfile(path):
            raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} file {path}")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def generator(name: str, pkg=PKG):
    return _module("gen", name, pkg)


def metric(name: str, pkg=PKG):
    return _module("metrics", name, pkg)


def cell_metrics(bench: dict, cell_name: str, trace: bool) -> list:
    """Names of the metrics a run of the cell reports: its end-to-end
    metrics with --trace 0, its per-layer metrics with --trace 1; a metric
    with a `workloads` list only in those cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m["name"] for m in group if cell_name in m.get("workloads", [cell_name])]
