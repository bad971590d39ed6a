"""The device trace of a short stretch of the window, reduced to what the
per-layer metrics read.

`Profiled` runs torch.profiler over two stretches, each between a
`start()` and a `stop()` after a synchronise, and reduces each trace at
once. The first records the device's activity alone, so the profiler
adds little to the host's time: the device's busy time (the union of its
operations' intervals) over the stretch's wall time, each kernel's total
time and the port kernel each belongs to come from it. The second
records the host's operations too, and only names the idle gaps by the
host operation running through them (recording every host operation
slows the host, so its idle share reads high: it is kept apart, as
`host_traced`). No Chrome trace is written.

The kernel classifier is a copy of profile_port.py's `port_kernel`: the
conv template's <mode, variant> names C, P, D, U, UB; the flash, lse,
backward and GEGLU entry points name F / M, L, DQ / DKV and G; everything
else is plain torch, of which `library_conv` picks the library's
convolution kernels (cuDNN / CUTLASS implicit GEMMs and their transforms
are told apart by name).
"""
from __future__ import annotations

import bisect
import collections
import re
import time
from typing import Dict, List, Optional, Tuple

CONV_MODES = {("1", "0"): "C", ("1", "1"): "P", ("2", "0"): "D",
              ("1", "2"): "U", ("2", "3"): "UB", ("1", "false"): "C",
              ("1", "true"): "P", ("2", "false"): "D"}
ENTRIES = (("flash_bwd_wg_kernel", "DQ / DKV"), ("lse_wg_kernel", "L"),
           ("flash_wg_kernel", "F / M"), ("geglu_wg_kernel", "G"),
           ("conv_mma_kernel", "C"))
ATTN_KERNELS = ("F / M", "L", "DQ / DKV")
CONV_KERNELS = ("C", "P", "D", "U", "UB")
LIBRARY_CONV = re.compile(r"(fprop|dgrad|implicit_gemm|implicit_convolve|"
                          r"conv2d_|convolve_|cudnn::.*conv)", re.I)
PLAIN = "plain torch"


def port_kernel(name: str) -> str:
    """The port kernel that a trace's kernel name belongs to, or "plain
    torch"."""
    m = re.search(r"wg_conv_kernel<(\d+), (\w+)", name)
    if m:
        return CONV_MODES.get(m.groups(), PLAIN)
    m = re.search(r"wg_splitk_reduce<(\d+), (\d+)>", name)
    if m:
        return CONV_MODES.get(m.groups(), PLAIN)
    if "wg_splitk_reduce" in name:
        return "C"
    return next((k for entry, k in ENTRIES if entry in name), PLAIN)


def library_conv(name: str) -> bool:
    """A library convolution kernel (plain torch's F.conv2d on cuDNN)."""
    return port_kernel(name) == PLAIN and bool(LIBRARY_CONV.search(name))


def union_seconds(spans: List[Tuple[float, float]]) -> float:
    """The length of the union of [start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def gaps(spans: List[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The idle intervals of [lo, hi) outside the union of `spans`."""
    out, reach = [], lo
    for start, end in sorted(spans):
        if start > reach:
            out.append((reach, min(start, hi)))
        reach = max(reach, end)
    if reach < hi:
        out.append((reach, hi))
    return [(a, b) for a, b in out if b > a]


def name_gaps(idle: List[Tuple[float, float]],
              host: List[Tuple[float, float, str]],
              top: int = 10) -> List[List]:
    """Total idle seconds by the top-level host operation running at each
    gap's middle ("python between ops" where none is), the `top` largest;
    times in seconds."""
    host = sorted(host)
    starts = [h[0] for h in host]
    by = collections.defaultdict(float)
    for a, b in idle:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        name = "python between ops"
        # top-level ops of one thread do not overlap: the latest start
        # before the middle that still runs through it
        for j in range(i - 1, max(-1, i - 65), -1):
            s, e, n = host[j]
            if s <= mid < e:
                name = n
                break
        by[name] += b - a
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])][:top]


def reduce_events(device: List[Tuple[float, float, str]],
                  host: List[Tuple[float, float, str]],
                  window_s: float) -> dict:
    """device / host: (start, end, name) in seconds on one clock."""
    spans = [(s, e) for s, e, _ in device]
    kernels = collections.defaultdict(float)
    for s, e, n in device:
        kernels[n] += e - s
    lo = min((s for s, _ in spans), default=0.0)
    hi = max((e for _, e in spans), default=0.0)
    by_port = collections.defaultdict(float)
    lib_conv = 0.0
    for n, t in kernels.items():
        by_port[port_kernel(n)] += t
        if library_conv(n):
            lib_conv += t
    return {
        "window_s": window_s,
        "busy_s": union_seconds(spans),
        "device_s": sum(kernels.values()),
        "by_port": dict(by_port),
        "library_conv_s": lib_conv,
        "device_ops": [[n, t] for n, t in sorted(
            kernels.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": name_gaps(gaps(spans, lo, hi), host),
        "n_device_ops": len(device),
    }


class Profiled:
    """torch.profiler over two stretches, each from start() to stop() and
    reduced at stop(): the device alone, then host and device. `summary`
    is the first's reduction with the second's idle gaps once both ran."""

    def __init__(self):
        self.summary: Optional[dict] = None
        self.touched = 0  # starts and stops so far
        self.stretches: List[dict] = []
        self._prof = None
        self._t0 = 0.0

    def start(self) -> None:
        import torch
        torch.cuda.synchronize()
        act = [torch.profiler.ProfilerActivity.CUDA]
        if self.stretches:
            act.append(torch.profiler.ProfilerActivity.CPU)
        self._prof = torch.profiler.profile(activities=act)
        self._prof.__enter__()
        self.touched += 1
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        window = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        device, host = [], []
        for e in self._prof.events():
            span = (e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
            if e.device_type == torch.autograd.DeviceType.CUDA:
                device.append(span)
            elif e.cpu_parent is None:
                host.append(span)
        self._prof = None
        self.touched += 1
        self.stretches.append(reduce_events(device, host, window))
        if len(self.stretches) == 2:
            self.summary = merge(*self.stretches)

    @property
    def active(self) -> bool:
        return self._prof is not None


def merge(device_only: dict, with_host: dict) -> dict:
    """The device-only stretch's reduction, with the idle gaps named in
    the stretch that recorded the host, and that stretch's busy and wall
    seconds as `host_traced`."""
    return dict(device_only, idle_gaps=with_host["idle_gaps"],
                host_traced={"busy_s": with_host["busy_s"],
                             "window_s": with_host["window_s"]})
