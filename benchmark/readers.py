"""What the metric files under metrics/ read from a run.

A run is the dict that run.py hands every reader: job ("serve" or
"train"), units completed in the window and its seconds, setup_s,
peak_bytes, the reduced trace of the profiled steps (trace.py) and the
ops counted for them (counts.py), the window's model FLOPs and the VAE's
milliseconds per frame. A reader returns None where the run holds
nothing for it (another job, no trace, no kernel of its class in the
trace): the harness then leaves the metric out. A share of a roofline or
of the peak is never clipped.
"""
from __future__ import annotations

from typing import Optional

from benchmark import counts
from benchmark.trace import ATTN_KERNELS, CONV_KERNELS, PLAIN


def rate(run: dict, job: str) -> Optional[float]:
    """Units completed over the window's seconds."""
    if run["job"] != job or run["window_s"] <= 0:
        return None
    return run["units"] / run["window_s"]


def traced(run: dict, job: str) -> Optional[dict]:
    t = run.get("trace")
    return t if run["job"] == job and t and t["device_s"] > 0 else None


def plain_share(run: dict, job: str) -> Optional[float]:
    """% of the profiled device time in kernels of no port kernel."""
    t = traced(run, job)
    return None if t is None else \
        100.0 * t["by_port"].get(PLAIN, 0.0) / t["device_s"]


def idle_share(run: dict, job: str) -> Optional[float]:
    """% of the profiled stretch's wall time with nothing on the device."""
    t = traced(run, job)
    return None if t is None else \
        100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline(run: dict, job: str, cls: str) -> Optional[float]:
    """% of the least time for the profiled steps' `cls` work ("attn" or
    "conv") in the time of the kernels that do it."""
    t = traced(run, job)
    if t is None or not run.get("profiled_ops"):
        return None
    names = ATTN_KERNELS if cls == "attn" else CONV_KERNELS
    spent = sum(t["by_port"].get(n, 0.0) for n in names)
    if cls == "conv":
        spent += t["library_conv_s"]
    ops = [o for o in run["profiled_ops"] if o.cls == cls]
    if spent <= 0 or not ops:
        return None
    return 100.0 * counts.least_seconds(ops) / spent


def mfu(run: dict, job: str) -> Optional[float]:
    """% of the bf16 peak in the model FLOPs of the window's completed
    units, over their seconds; a traced run leaves out the units that the
    profiler ran in."""
    if run["job"] != job or run["flops_s"] <= 0 or not run["window_flops"]:
        return None
    return 100.0 * run["window_flops"] / (run["flops_s"] * counts.PEAK_FLOPS)


def peak_gib(run: dict, job: str) -> Optional[float]:
    if run["job"] != job or not run["peak_bytes"]:
        return None
    return run["peak_bytes"] / 2 ** 30
