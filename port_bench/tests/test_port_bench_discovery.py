"""A configuration, a traffic mix, a cell, a per-layer metric and a family
are added by new files and new entries of BENCHMARK.json alone: in a copy
of the benchmark, with no file of it edited, a new serving cell runs (on
the CPU, at a tiny size) and reports the new metric, and the benchmark's
own CPU tests take a new training cell of a new family in."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

NEW_METRIC = '''"""Requests served in the traced window."""
UNIT = "requests"
LAYER = "step and request"
MOVES = "serve_p95_ms"
SOURCE = "host_clock"


def read(ctx):
    return ctx.counters.get("requests")
'''

RUN = """
import json, sys
sys.path.insert(0, {copy!r})
from port_bench import harness
assert harness.BENCH_DIR.startswith({copy!r})
r = harness.run("ex1-galerkin.serve-n64", 7, 0.3, True, device="cpu")
print(json.dumps({{"correct": r["correct"], "metrics": sorted(r["metrics"])}}))
"""


def _files(folder: str) -> dict:
    return {os.path.join(d, f): open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(folder) if "__pycache__" not in d for f in fs}


def test_new_files_make_a_new_cell(tmp_path):
    copy = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "port_bench"), os.path.join(copy, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _files(os.path.join(copy, "port_bench"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    pb = os.path.join(copy, "port_bench")

    config = json.load(open(os.path.join(pb, "configs", "ex1-fourier.json")))
    config["name"] = "ex1-galerkin"
    config["model"]["attention_type"] = "galerkin"
    json.dump(config, open(os.path.join(pb, "configs", "ex1-galerkin.json"), "w"))
    json.dump(dict(driver="serve_closed", grid=dict(n=64), batch=2, pool=3, keep_every=4,
                   why="tiny"), open(os.path.join(pb, "traffic", "serve-n64.json"), "w"))
    json.dump(dict(config="ex1-galerkin", traffic="serve-n64", chips=1,
                   flops={"request": 10 ** 6}, limits={"answer_gap": 1e-4}),
              open(os.path.join(pb, "workloads", "ex1-galerkin.serve-n64.json"), "w"))
    with open(os.path.join(pb, "metrics", "requests.serve.py"), "w") as f:
        f.write(NEW_METRIC)

    cell = "ex1-galerkin.serve-n64"
    bench["configs"].append(dict(bench["configs"][0], name="ex1-galerkin",
                                 file="port_bench/configs/ex1-galerkin.json"))
    bench["workloads"].append(dict(name=cell, config="ex1-galerkin", traffic="serve-n64",
                                   chips=1, why="tiny"))
    for metric in bench["end_to_end"]:
        if "serve_p95_ms" == metric["name"]:
            metric["workloads"].append(cell)
    bench["per_layer"].append(dict(name="requests.serve", unit="requests", better="higher",
                                   source="host_clock", layer="step and request",
                                   moves="serve_p95_ms", workloads=[cell]))
    json.dump(bench, open(os.path.join(copy, "BENCHMARK.json"), "w"))

    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", RUN.format(copy=copy)], capture_output=True,
                         text=True, timeout=300, cwd=copy, env=env, check=True).stdout
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"]
    assert "requests.serve" in result["metrics"] and "setup_data_s" not in result["metrics"]
    after = {p: open(p, "rb").read() for p in before}
    assert after == before   # no file of the benchmark was edited


# the cell whose files the new training cell copies, and the new names
MODEL_CELL = "ex2-galerkin.train-f141"
NEW_FAMILY, NEW_CONFIG, NEW_TRAFFIC = "darcy_twin", "ex2-twin", "train-f85"
NEW_CELL = f"{NEW_CONFIG}.{NEW_TRAFFIC}"
TESTS = ["test_port_bench_manifest.py", "test_port_bench_reference.py", "test_port_bench_cost.py"]


def _write(obj, *parts):
    with open(os.path.join(*parts), "w") as f:
        json.dump(obj, f, indent=1)


def test_new_files_make_a_new_training_family(tmp_path):
    """A family, a configuration, a training mix and its tiny size, and a
    cell with its counted FLOPs, in a copy of the benchmark with its tests:
    the copy's manifest, reference and cost tests pass and take the new
    family and cell in, and no file that the copy had is edited."""
    copy = str(tmp_path)
    pb = os.path.join(copy, "port_bench")
    shutil.copytree(os.path.join(ROOT, "port_bench"), pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy)
    before = _files(pb)
    bench = json.load(open(os.path.join(copy, "BENCHMARK.json")))
    model = json.load(open(os.path.join(pb, "workloads", f"{MODEL_CELL}.json")))
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONDONTWRITEBYTECODE="1", OMP_NUM_THREADS="1")

    shutil.copy(os.path.join(pb, "families", "darcy.py"),
                os.path.join(pb, "families", f"{NEW_FAMILY}.py"))
    config = json.load(open(os.path.join(pb, "configs", f"{model['config']}.json")))
    _write(dict(config, name=NEW_CONFIG, family=NEW_FAMILY), pb, "configs", f"{NEW_CONFIG}.json")
    mix = json.load(open(os.path.join(pb, "traffic", f"{model['traffic']}.json")))
    _write(dict(mix, grid=dict(fine=85, coarse=29), why="ex2 at subsample 5 and 15 of 421"),
           pb, "traffic", f"{NEW_TRAFFIC}.json")
    os.makedirs(os.path.join(pb, "tests", "tiny"), exist_ok=True)
    _write(dict(grid=dict(fine=41, coarse=11), batch=2, val_batch=2, train_samples=8,
                valid_samples=4), pb, "tests", "tiny", f"{NEW_TRAFFIC}.json")
    # flops.py reads the cell's files: the cell is written, counted, written again
    workload = dict(model, config=NEW_CONFIG, traffic=NEW_TRAFFIC)
    _write(workload, pb, "workloads", f"{NEW_CELL}.json")
    counted = subprocess.run([sys.executable, "port_bench/flops.py", NEW_CELL], cwd=copy,
                             env=env, capture_output=True, text=True, timeout=120, check=True)
    workload["flops"] = json.loads(counted.stdout.strip().splitlines()[-1].split(" ", 1)[1])
    assert workload["flops"] != model["flops"]
    _write(workload, pb, "workloads", f"{NEW_CELL}.json")

    bench["configs"].append(dict(next(c for c in bench["configs"]
                                      if c["name"] == model["config"]),
                                 name=NEW_CONFIG, file=f"port_bench/configs/{NEW_CONFIG}.json"))
    bench["workloads"].append(dict(name=NEW_CELL, config=NEW_CONFIG, traffic=NEW_TRAFFIC,
                                   chips=1, why="tiny"))
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if MODEL_CELL in metric.get("workloads", ()):
            metric["workloads"].append(NEW_CELL)
    _write(bench, copy, "BENCHMARK.json")

    tests = [os.path.join("port_bench", "tests", t) for t in TESTS]
    done = subprocess.run([sys.executable, "-m", "pytest", *tests, "-v", "-p", "no:cacheprovider",
                           "-p", "no:randomly", "-p", "no:xdist"], cwd=copy, env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout[-4000:]
    for test in (f"test_forward_matches_port[eval-{NEW_CELL}]",
                 f"test_loss_matches_port[{NEW_CELL}]",
                 f"test_cell_files_and_reports[{NEW_CELL}]",
                 f"test_stored_flops_are_the_reference_count[{NEW_CELL}]"):
        assert f"{test} PASSED" in done.stdout, test
    after = {p: open(p, "rb").read() for p in before}
    assert after == before   # no file of the benchmark was edited
