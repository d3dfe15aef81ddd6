"""BENCHMARK.json against the benchmark's contract and its own files."""
from __future__ import annotations

import json
import os
import re

import pytest
from conftest import ROOT

from port_bench import harness

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32
    assert all(1 <= len(w) <= 200 and "\t" not in w and "\n" not in w
               for w in BENCH["command"])


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]] + CELLS
                         + [m["name"] for m in METRICS]
                         + [w["traffic"] for w in BENCH["workloads"]])
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    keys = {"name", "unit", "better", "source", "workloads"}
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= keys | {"bound"} and "bound" in metric
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= keys | {"layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
        assert metric["moves"] in [m["name"] for m in BENCH["end_to_end"]]
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)


def test_names_unique():
    for group in (METRICS, BENCH["configs"], BENCH["workloads"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_file_agrees(metric):
    """Each per-layer metric's reader declares what BENCHMARK.json says of it;
    a roofline or mfu share is a percentage."""
    reader = harness.load_module(os.path.join(harness.BENCH_DIR, "metrics",
                                              f"{metric['name']}.py"))
    assert (reader.UNIT, reader.LAYER, reader.MOVES, reader.SOURCE) == (
        metric["unit"], metric["layer"], metric["moves"], metric["source"])
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"
    for cell in metric["workloads"]:
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        assert cell in moved.get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_reports(cell):
    """Each cell's files exist and agree with its entry; it reports setup_s,
    another end-to-end metric and a per-layer metric."""
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    data = harness.load_json(harness.BENCH_DIR, "workloads", f"{cell}.json")
    assert (data["config"], data["traffic"], data["chips"]) == (
        entry["config"], entry["traffic"], entry["chips"])
    assert entry["chips"] == 1 and 1 <= len(entry["why"]) <= 200
    e2e = [m["name"] for m in BENCH["end_to_end"] if harness.applies(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(harness.applies(m, cell, e2e) for m in BENCH["per_layer"])
    harness.Cell.load(cell).driver()


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert config["file"].startswith("port_bench/configs/")
    data = harness.load_json(ROOT, config["file"])
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"] == []
    assert 1 <= len(config["why"]) <= 200 and 1 <= len(config["source"]) <= 200
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


def test_model_configs_match_config_yml():
    """Each configuration's model block is the reference's config.yml block
    that its ``config_yml`` names, as the port embeds it."""
    from galerkin_transformer_torch.utils.config import CONFIGS
    for config in BENCH["configs"]:
        data = harness.load_json(ROOT, config["file"])
        block = CONFIGS[data["config_yml"]]
        assert data["model"] == json.loads(json.dumps(block)), config["name"]
