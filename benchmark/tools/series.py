"""Run cells of BENCHMARK.json one process a run, in order, and keep each
run's result line, its checks and the card's facts (the first line
of its standard error) as one JSON line.

  python3 -m benchmark.tools.series --out runs.jsonl
      --cells story-frame-3ref-b4,train-stage2-b12 --seeds 11,12,13
      [--seconds 40] [--trace 0]

Every (cell, seed) pair runs `python3 -m benchmark.run` in a process of
its own from the repository root; a cell's runs follow each other, in
the order of --seeds. --seconds defaults to BENCHMARK.json's
run_seconds. The record holds the return code, the process's wall
seconds, the result line (None when there is none) and the last 4,000
characters of its standard error.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def last_json(text: str):
    for line in reversed(text.strip().splitlines()):
        try:
            return json.loads(line)
        except ValueError:
            continue
    return None


def run_one(cell: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", cell,
           "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    card = next((json.loads(s) for s in p.stderr.splitlines()
                 if s.startswith('{"card"')), None)
    return {"cell": cell, "seed": seed, "trace": trace, "seconds": seconds,
            "rc": p.returncode, "wall_s": time.perf_counter() - t0,
            "card": card,
            "line": last_json(p.stdout), "stderr": p.stderr[-4000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    args = ap.parse_args(argv)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or spec["run_seconds"]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for cell in args.cells.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            rec = run_one(cell, seed, seconds, args.trace)
            with open(out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            line = rec["line"] or {}
            print(json.dumps({k: rec[k] for k in ("cell", "seed", "trace",
                                                  "rc", "wall_s")}
                             | {"correct": line.get("correct"),
                                "metrics": line.get("metrics"),
                                "checks": line.get("checks")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
