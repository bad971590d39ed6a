"""The readings that the limits of `correct` are set from.

  python3 -m benchmark.tools.calibrate --cell story-frame-3ref-b4
      --seeds 11,12,...,22 --control-seeds 11,12,13 --out cal.jsonl

In one process, for each seed: the cell's set-up and warm-up, one unit
of its traffic (a frame call, a micro-step) at the cell's own size, and
the check's numbers of the program against the float32 reference (the
lower readings). For the control seeds also the kind's `readings`: the
reference in float8 put in the program's place against the float32
reference, and, in training, the reference with half of each batch left
out, with its update's sign flipped and with its parameters left
unchanged. One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from benchmark.core import Bench
from benchmark.reference.numerics import Numerics
from benchmark.run import Run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    bench = Bench()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = Run(bench, args.cell, seed, 0.0, False,
                  torch.device("cuda", 0))
        line = run.run(start=t0)
        rec = {"cell": args.cell, "seed": seed,
               "checks": {n: c["value"] for n, c in line["checks"].items()},
               "times": run.times}
        if seed in control:
            t1 = time.perf_counter()
            rec["readings"] = run.kind.readings(Numerics("fp8"))
            rec["times"]["readings_s"] = time.perf_counter() - t1
        rec["device"] = line["device"]
        del run
        torch.cuda.empty_cache()
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
