"""Every file that BENCHMARK.json names loads and resolves, and the
benchmark's own data files say what BENCHMARK.json says."""

import importlib.util
import json
import re

import pytest
import yaml

from tiny import BENCH

ROOT = BENCH.parent
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
# the numbers each job kind compares
LIMITS = {"denoise": {"forward_rel_l2", "sampler_rel_l2", "timestep_mismatches"},
          "qlora": {"loss_rel_gap", "first_grad_gap", "change_gap"}}


def test_top_level_keys():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["bench_h100"]
    assert BENCHMARK["command"] == ["python3", "bench_h100/run.py"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51


def test_names_and_bounds():
    names = [x["name"] for part in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCHMARK[part]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in e2e
        assert all(c in m.get("workloads", CELLS) for c in CELLS if c in m.get("workloads", []))


@pytest.mark.parametrize("conf", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert conf["file"].startswith("bench_h100/configs/")
    assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"] == []
    assert cfg["dim"] % cfg["num_heads"] == 0


@pytest.mark.parametrize("entry", BENCHMARK["workloads"], ids=lambda w: w["name"])
def test_cell_file(entry):
    spec = json.loads((BENCH / "workloads" / f"{entry['name']}.json").read_text())
    assert spec["name"] == entry["name"] and spec["config"] == entry["config"]
    assert spec["chips"] == entry["chips"] == 1
    assert (BENCH / "jobs" / f"{spec['job']}.py").exists()
    assert (BENCH / "schemes" / f"{spec['scheme']}.yaml").exists()
    assert set(spec["limits"]) == LIMITS[spec["job"]]
    assert spec["limits"].get("timestep_mismatches", 0) == 0
    if spec["job"] == "denoise":
        # generate's keywords and the QuantCtx's fields, passed through as data
        assert {"cfg_mode", "guide_scale", "sample_solver", "shift"} <= set(
            spec["traffic"]["generate"])
        assert isinstance(spec["traffic"].get("ctx", {}), dict)
    reported = [m["name"] for m in BENCHMARK["end_to_end"]
                if entry["name"] in m.get("workloads", [entry["name"]])]
    assert "setup_s" in reported and len(reported) >= 2
    assert any(entry["name"] in m.get("workloads", [entry["name"]])
               for m in BENCHMARK["per_layer"])


@pytest.mark.parametrize("metric", BENCHMARK["per_layer"], ids=lambda m: m["name"])
def test_metric_reader(metric):
    path = BENCH / "metrics" / f"{metric['name']}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read(None) is None and mod.read({"kind": "other"}) is None


@pytest.mark.parametrize("name", ["wan_w8a8_speed", "wan_w4a8_14b", "wan_w4a8_mixed"])
def test_scheme_is_the_shipped_yaml(name):
    """The frozen copy says what the shipped YAML says, less its step cache."""
    ours = yaml.safe_load((BENCH / "schemes" / f"{name}.yaml").read_text())
    theirs = yaml.safe_load((ROOT / "quant_configs" / f"{name}.yaml").read_text())
    theirs.pop("cache", None)
    assert ours == theirs
