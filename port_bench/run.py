"""Run one cell of the port's benchmark once and print its result.

    python3 port_bench/run.py --workload ex1-fourier.train-n8192 --seed 7 \\
        --seconds 10 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``compared``: each number the correctness check
compared, beside its limit.  The last lines of standard error repeat
those numbers.  Without a CUDA device, or with fewer than the cell asks
for, it prints no result and exits with 2; if the process holds JAX or the
JAX package after the window, with 3.

Build and kernel caches are kept at fixed paths inside the checkout
(``build/``, where the port builds its kernels, and ``build/cache/``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "nv"}


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: trace the window and report the per-layer metrics")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "build", "cache", sub)
    os.environ["USE_FLAX"] = "0"
    # the bytecode of every module the run imports, torch's too: only the
    # first run in a checkout compiles it
    sys.pycache_prefix = os.path.join(ROOT, "build", "cache", "pycache")
    sys.dont_write_bytecode = False
    sys.path.insert(0, ROOT)
    import torch
    from port_bench import harness

    chips = next((w["chips"] for w in harness.manifest()["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         t_start=T_START)
    held = harness.imported_forbidden()
    if held:
        print(f"the process holds {', '.join(held)} after the window", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
