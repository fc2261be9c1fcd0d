"""Every cell, configuration and metric that BENCHMARK.json names has its
file, and the file agrees with the contract's shapes."""

import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["file"].startswith("benchmark/")
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    for key in cfg["reduced"]:
        assert NAME.match(key) and not WIDTHS.search(key), key
        assert key in data
    assert any(c["config"] == cfg["name"] for c in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_file(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    data = json.loads((BENCH / "workloads" / f"{cell['name']}.json").read_text())
    assert data["name"] == cell["name"] and data["config"] == cell["config"]
    assert data["chips"] == cell["chips"] and data["why"] == cell["why"]
    assert (BENCH / "drivers" / f"{data['driver']}.py").exists()
    assert (BENCH / "configs" / f"{data['config']}.json").exists()
    assert "reduced" in data and data["limits"]


def _reported(cell):
    return [m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])]


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {c["name"] for c in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert (BENCH / "metrics" / f"{metric['name']}.py").exists()
        assert set(metric) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        for cell in metric["workloads"]:
            assert metric["moves"] in _reported(cell)


def test_every_cell_reports_enough():
    for cell in SPEC["workloads"]:
        e2e = _reported(cell["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell["name"] in m["workloads"] for m in SPEC["per_layer"])


def test_layer_names_agree():
    by_layer = {}
    for m in SPEC["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())
