"""BENCHMARK.json against the contract's shape, and the pieces found by
name: a configuration, a traffic mix and a metric added as new files only."""

import json
import os
import re

from portbench import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_names_and_files():
    bench = registry.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    cfgs = {c["name"] for c in bench["configs"]}
    metrics = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in cfgs and len(w["why"]) <= 200
        registry.traffic(w["traffic"])
        cfg = registry.config(bench, w["config"])
        registry.generator(cfg["generator"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert callable(registry.metric(m["name"]).read)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", [])) <= {w["name"] for w in bench["workloads"]}
    assert len(metrics) == len(bench["end_to_end"]) + len(bench["per_layer"])
    for c in bench["configs"]:
        with open(os.path.join(registry.ROOT, c["file"])) as fh:
            assert json.load(fh)["source"] == c["source"]


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        e2e = registry.cell_metrics(bench, w["name"], trace=False)
        layer = registry.cell_metrics(bench, w["name"], trace=True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer


def test_new_pieces_are_found_by_name(tmp_path):
    """A later PR adds a cell as files only: a configuration, a traffic mix,
    a generator and a metric under new names, found with no edit here."""
    pkg = tmp_path / "portbench"
    for d in ("configs", "traffic", "gen", "metrics"):
        (pkg / d).mkdir(parents=True)
    (pkg / "configs" / "new_cfg.json").write_text(json.dumps({"generator": "new_gen", "n": 3}))
    (pkg / "traffic" / "b7.json").write_text(json.dumps({"batch": 7, "pool": 1}))
    (pkg / "gen" / "new_gen.py").write_text("def make(cfg, batch, seed, device):\n    return batch\n")
    (pkg / "metrics" / "new.metric.py").write_text("def read(run):\n    return 42.0\n")
    bench = {
        "configs": [{"name": "new_cfg", "file": "portbench/configs/new_cfg.json"}],
        "workloads": [{"name": "new_cfg.b7", "config": "new_cfg", "traffic": "b7", "chips": 1}],
        "end_to_end": [{"name": "setup_s"}],
        "per_layer": [{"name": "new.metric", "workloads": ["new_cfg.b7"]}],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    bench = registry.benchmark(str(tmp_path))
    cell = registry.cell(bench, "new_cfg.b7")
    cfg = registry.config(bench, cell["config"], root=str(tmp_path))
    assert registry.traffic(cell["traffic"], pkg=str(pkg))["batch"] == 7
    assert registry.generator(cfg["generator"], pkg=str(pkg)).make(cfg, 7, 0, "cpu") == 7
    assert registry.cell_metrics(bench, "new_cfg.b7", trace=True) == ["new.metric"]
    assert registry.metric("new.metric", pkg=str(pkg)).read(None) == 42.0
