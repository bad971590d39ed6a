"""Run one cell of BENCHMARK.json once on this machine's card.

  python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
      --trace <0|1>

Set-up (CUDA context, the kernels' library, the models and their seeded
weights made on the card, the cell's warm-up) runs from process start to
the window's start (`setup_s`). The window then runs whole units of the
cell's traffic kind (frame calls, micro-steps) back to back until
--seconds have passed; its rate is the units completed over the time to
the last one's end. With --trace 1 the same run also profiles a few whole
steps of the window and reports the per-layer metrics instead of the
end-to-end ones. After the window: the peak memory is read, the
program's state freed, and the float32 reference recomputes a sample of
the window's outputs; each number compared is printed beside its limit
on standard error's last lines and under "checks", the last key of the
result's line, which is standard output's last line.

Exits 3 without a result when there is no card, too few cards, or the
JAX package or JAX is loaded once the window has closed: looked for then,
after the check, and before the result is printed.
"""
from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from typing import List, Optional, Sequence  # noqa: E402

from benchmark.core import Bench, kind_class  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "storygen_tpu"}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & FORBIDDEN)


class Run:
    """One run of one cell: set-up, window, check. `device` and `dtype`
    default to the card and bf16; the CPU tests give the CPU, float32 and
    a tiny configuration."""

    def __init__(self, bench: Bench, cell: str, seed: int, seconds: float,
                 trace: bool, device=None, cfg: Optional[dict] = None,
                 traffic: Optional[dict] = None, dtype=None):
        import torch
        self.bench, self.cell, self.seed = bench, cell, seed
        self.seconds, self.trace = seconds, trace
        w = bench.cell(cell)
        self.cfg = cfg or bench.config(w["config"])
        self.traffic = traffic or bench.traffic(w["traffic"])
        self.dev = torch.device(device or "cuda")
        self.dtype = dtype or torch.bfloat16
        self.kind = kind_class(self.traffic["kind"])(
            self.cfg, self.traffic, seed, self.dev, self.dtype)

    def sync(self) -> None:
        import torch
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def run(self, start: float = PROCESS_START) -> dict:
        import torch
        from benchmark.trace import Profiled
        k = self.kind
        t_setup = time.perf_counter()
        k.setup()
        cuda = self.dev.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)
        t_warm = time.perf_counter()
        k.warm_up()
        self.sync()
        prof = Profiled() if self.trace and cuda else None
        k.record_vae = bool(prof)
        attempted = completed = 0
        done: List[int] = []
        # units the profiler did not touch, and their seconds: what mfu
        # reads in a traced run
        clean: List[int] = []
        clean_s = 0.0
        unit_s: List[float] = []
        t0 = time.perf_counter()
        setup_s = t0 - start
        t_end, i = t0, 0
        while True:
            idx = k.start_index + i
            if prof is not None and i == 0:
                k.profile_call(prof)
            touched = prof.touched if prof else 0
            t_unit = time.perf_counter()
            try:
                got = k.call(idx)
            except Exception:  # a unit that raises counts as failed
                traceback.print_exc(file=sys.stderr)
                got = 0
                self.sync()
            attempted += k.b
            completed += got
            i += 1
            t_end = time.perf_counter()
            unit_s.append(t_end - t_unit)
            if got:
                done.append(idx)
                if not prof or (prof.touched == touched and not prof.active):
                    clean.append(idx)
                    clean_s += t_end - t_unit
            if t_end - t0 >= self.seconds:
                break
        window_s = t_end - t0
        peak = torch.cuda.max_memory_allocated(self.dev) if cuda else 0
        self.times = {"setup_s": setup_s, "before_models_s": t_setup - start,
                      "models_s": t_warm - t_setup, "warm_up_s": t0 - t_warm,
                      "window_s": window_s}
        run = {"job": k.job, "units": completed, "window_s": window_s,
               "setup_s": setup_s, "peak_bytes": peak,
               "trace": prof.summary if prof else None,
               "vae_ms": k.vae_ms(), "window_flops": k.window_flops(clean),
               "flops_s": clean_s,
               "profiled_ops": k.profiled_ops() if prof and prof.summary
               else None}
        metrics = {}
        for m in self.bench.metrics(self.cell, per_layer=self.trace):
            value = self.bench.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        looked = forbidden_modules()
        k.release()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        from benchmark.reference.numerics import Numerics
        checks = self.kind.check(Numerics("fp32"))
        self.times["check_s"] = time.perf_counter() - t_check
        # once the window has closed, and again after the check
        self.forbidden = sorted(set(looked) | set(forbidden_modules()))
        self.unit_s = unit_s
        self.host_traced = run["trace"]["host_traced"] if run["trace"] \
            else None
        limits = self.bench.limits(self.cell)
        correct = bool(done) and all(
            limits.get(n) is not None and math.isfinite(v)
            and v <= limits[n] for n, v in checks.items())
        device = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(self.dev) if cuda
                  else "cpu", "count": 1, "memory_peak_bytes": peak}
        line = {"correct": correct, "attempted": attempted,
                "failed": attempted - completed, "metrics": metrics,
                "device": device}
        if run["trace"]:
            device["busy_s"] = run["trace"]["busy_s"]
            device["window_s"] = run["trace"]["window_s"]
            line["breakdown"] = {"device_ops": run["trace"]["device_ops"],
                                 "idle_gaps": run["trace"]["idle_gaps"]}
        line["checks"] = {n: {"value": v, "limit": limits.get(n)}
                          for n, v in checks.items()}
        return line


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    import torch
    bench = Bench()
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from storygen_tpu_torch.utils.device import card_facts
    dev = torch.device("cuda", 0)
    print(json.dumps({"card": card_facts(dev)}), file=sys.stderr,
          flush=True)
    run = Run(bench, args.workload, args.seed, args.seconds,
              bool(args.trace), dev)
    return report(run, run.run())


def report(run: Run, line: dict) -> int:
    """Print the result, or nothing and 3 when JAX or the JAX package
    was loaded at any of the looks: once the window closed, after the
    check, and now, just before the result."""
    found = sorted(set(run.forbidden) | set(forbidden_modules()))
    if found:
        print(f"benchmark: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    print("benchmark: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                    run.times.items()), file=sys.stderr)
    print("benchmark: unit seconds " + " ".join(
        f"{t:.3f}" for t in run.unit_s), file=sys.stderr)
    if run.host_traced:
        print(f"benchmark: the stretch traced with the host: "
              f"{json.dumps(run.host_traced)}", file=sys.stderr)
    for n, c in line["checks"].items():
        print(f"check {n}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
