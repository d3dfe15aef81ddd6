"""A configuration, a traffic mix, a cell and a per-layer metric are added
by new files and new entries of BENCHMARK.json alone: in a copy of the
benchmark, with no file of it edited, the new cell runs (on the CPU, at a
tiny size) and reports the new metric."""
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


def test_new_files_make_a_new_cell(tmp_path):
    copy = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "port_bench"), os.path.join(copy, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {os.path.join(d, f): open(os.path.join(d, f), "rb").read()
              for d, _, fs in os.walk(os.path.join(copy, "port_bench")) for f in fs}
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
