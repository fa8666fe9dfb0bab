"""A later change adds a configuration, a cell or a per-layer metric by
adding files only: the harness finds each by its name."""

import json
import shutil

import pytest

from perfbench.harness import common


@pytest.fixture
def bench_copy(tmp_path, monkeypatch):
    """A copy of the benchmark's data and readers that a test may add to."""
    for sub in ("configs", "traffic", "workloads", "metrics", "drivers"):
        shutil.copytree(common.BENCH / sub, tmp_path / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(common, "BENCH", tmp_path)
    return tmp_path


def test_new_cell_config_and_traffic_are_found(bench_copy):
    cfg = json.loads((bench_copy / "configs" / "mistral-7b-v0.3.json").read_text())
    cfg["num_hidden_layers"] = 4
    (bench_copy / "configs" / "new-model.json").write_text(json.dumps(cfg))
    mix = {"arrival": {"kind": "poisson", "rate": 1.5},
           "prompt": {"kind": "uniform", "min": 32, "max": 64},
           "output": {"kind": "uniform", "min": 16, "max": 32}, "block": 4}
    (bench_copy / "traffic" / "steady.json").write_text(json.dumps(mix))
    cell = json.loads((bench_copy / "workloads" / "mistral7b.chat.json").read_text())
    cell.update(config="new-model", traffic="steady")
    (bench_copy / "workloads" / "new-model.steady.json").write_text(json.dumps(cell))
    got = common.workload("new-model.steady")
    assert got["model"]["num_hidden_layers"] == 4
    assert got["traffic_mix"]["arrival"]["rate"] == 1.5
    assert common.load_module("drivers", got["driver"]).run


def test_new_metric_reader_is_found(bench_copy):
    (bench_copy / "metrics" / "queue_depth.chat.py").write_text(
        "def read(rec):\n    return rec.get('queue_depth')\n")
    bench = json.loads((common.ROOT / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "queue_depth.chat", "unit": "requests",
                               "better": "lower", "source": "host_clock",
                               "layer": "serving", "moves": "ttft_p90_s"})
    _, layer = common.metrics_of(bench, "mistral7b.chat")
    assert "queue_depth.chat" in [m["name"] for m in layer]
    _, layer = common.metrics_of(bench, "mistral7b.train_s4k")
    assert "queue_depth.chat" not in [m["name"] for m in layer]
    reader = common.load_module("metrics", "queue_depth.chat")
    assert reader.read({"queue_depth": 3}) == 3
    assert reader.read({}) is None


def test_every_cell_reports_setup_and_one_more(bench_copy):
    bench = json.loads((common.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        e2e, layer = common.metrics_of(bench, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
