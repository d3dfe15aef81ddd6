"""Readings behind the correctness limits, on the card: the numbers that
the check compares, for many seeds in one process, from sound runs of the
program, from its controls (the program with TF32 products on: cuBLAS and
cuDNN take float32 operands at TF32, the nearest precision below the
configuration's float32; and the program's own bf16 path, which runs the
attention on its bf16 kernels) or with a fault planted under the timed
path.

    python3 port_bench/control.py --workload ex1-fourier.train-n8192 \\
        --mode control --seeds 11,12,13 --seconds 0

Modes: ``sound``; ``control`` (TF32); ``bf16`` (the model built with the
bfloat16 compute type); ``frozen`` (the optimizer's step leaves the state
unchanged); ``half_batch`` (the step sees half of each batch); ``altered``
(one value of each answer, or the validation metric, is moved).  Training
cells need no window (``--seconds 0``: the validation compared is the
set-up epoch's); serving cells a short one.  Prints one JSON line per
seed, with what lies behind each number.  The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# mode: (float32 matmul precision, faults, compute dtype)
MODES = {"sound": ("highest", (), None), "control": ("high", (), None),
         "bf16": ("highest", (), "bfloat16"), "frozen": ("highest", ("frozen",), None),
         "half_batch": ("highest", ("half_batch",), None),
         "altered": ("highest", ("altered",), None)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", choices=sorted(MODES), default="sound")
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch
    from port_bench import harness
    precision, faults, dtype = MODES[args.mode]
    for seed in (int(s) for s in args.seeds.split(",")):
        details = {}
        result = harness.run(args.workload, seed, args.seconds, False, device=args.device,
                             precision=precision, faults=faults,
                             dtype=dtype and getattr(torch, dtype), details=details)
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "correct": result["correct"],
                          "compared": {k: v["value"] for k, v in result["compared"].items()},
                          "details": details}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
