"""Every cell file against its configuration by the harness's own loader,
and a cell, configuration, driver and per-layer metric added as files and
entries alone."""

import json
import shutil

import pytest

from bench_torch.harness import bench

BENCHMARK = bench.load_json(bench.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file_matches_its_configuration(cell):
    _, entry, c, config_entry, config = bench.load_cell(cell)
    assert c["name"] == cell
    assert config["name"] == entry["config"] == config_entry["name"]
    assert set(c["limits"]) and all(v >= 0 for v in c["limits"].values())
    driver = bench.load_module("traffic", c["traffic"])
    assert callable(driver.run)
    e2e, layer = bench.metrics_of(BENCHMARK, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:
        assert callable(bench.load_module("metrics", m["name"]).read)
        assert m["moves"] in names


def test_configs_hold_their_sources_keys():
    for c in BENCHMARK["configs"]:
        config = bench.load_json(bench.ROOT / c["file"])
        assert config["source"] == c["source"]
        assert not c["reduced"]


def test_added_by_files_alone(tmp_path):
    """A new configuration, cell, driver and metric, added as new files
    and BENCHMARK.json entries, are found and run by name."""
    root = tmp_path / "checkout"
    shutil.copytree(bench.BENCH_DIR, root / "bench_torch",
                    ignore=shutil.ignore_patterns("assets", "__pycache__"))
    b = json.loads(json.dumps(BENCHMARK))
    b["configs"].append({"name": "new_cfg", "source": "https://example.org",
                         "file": "bench_torch/configs/new_cfg.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "new_cfg.mix", "config": "new_cfg",
                           "traffic": "new_driver", "chips": 1,
                           "why": "test"})
    b["end_to_end"].append({"name": "new_rate", "unit": "1/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["new_cfg.mix"]})
    b["per_layer"].append({"name": "new.metric", "unit": "%",
                           "better": "higher", "source": "program_counter",
                           "layer": "device", "moves": "new_rate",
                           "workloads": ["new_cfg.mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    (root / "bench_torch/configs/new_cfg.json").write_text(
        json.dumps({"name": "new_cfg", "source": "https://example.org"}))
    (root / "bench_torch/workloads/new_cfg.mix.json").write_text(json.dumps(
        {"name": "new_cfg.mix", "config": "new_cfg",
         "traffic": "new_driver", "chips": 1, "why": "test",
         "params": {"n": 3}, "limits": {"gap": 0.0}}))
    (root / "bench_torch/traffic/new_driver.py").write_text(
        "def run(ctx):\n    return ctx.params['n']\n")
    (root / "bench_torch/metrics/new.metric.py").write_text(
        "def read(layer):\n    return layer.get('x')\n")

    _, entry, cell, _, config = bench.load_cell("new_cfg.mix", root=root)
    assert entry["traffic"] == cell["traffic"] == "new_driver"
    assert config["name"] == "new_cfg"
    driver = bench.load_module("traffic", "new_driver", root / "bench_torch")
    assert driver.run(type("C", (), {"params": cell["params"]})) == 3
    e2e, layer = bench.metrics_of(b, "new_cfg.mix")
    assert {m["name"] for m in e2e} == {"new_rate", "setup_s"}
    assert [m["name"] for m in layer] == ["new.metric"]
    metric = bench.load_module("metrics", "new.metric", root / "bench_torch")
    assert metric.read({"x": 1.5}) == 1.5 and metric.read({}) is None
    # the cells already there are untouched by the addition
    for name in CELLS:
        assert bench.metrics_of(b, name) == bench.metrics_of(BENCHMARK, name)


def test_seeds_are_stable_and_distinct():
    big = 2 ** 31 + 12345
    assert bench.sub_seed(big, "data") == bench.sub_seed(big, "data")
    assert bench.sub_seed(big, "data") != bench.sub_seed(big, "weights")
    assert bench.sub_seed(big, "data") != bench.sub_seed(big + 1, "data")
    assert 0 <= bench.sub_seed(2 ** 70, "x") < 2 ** 31


def test_judge():
    ok, checks = bench.judge({"a": 0.5, "b": 0}, {"a": 1.0, "b": 0})
    assert ok and checks["a"] == {"value": 0.5, "limit": 1.0}
    assert not bench.judge({"a": 2.0, "b": 0}, {"a": 1.0, "b": 0})[0]
    assert not bench.judge({"a": float("nan"), "b": 0}, {"a": 1.0,
                                                         "b": 0})[0]
    assert not bench.judge({"b": 0}, {"a": 1.0, "b": 0})[0]
