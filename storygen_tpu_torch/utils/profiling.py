"""Tracing and step timing. Counterpart of storygen_tpu/utils/profiling.py.

- `trace(logdir)`: a `torch.profiler` trace of the enclosed region (CPU
  activity, and CUDA activity where CUDA is available), written into
  `logdir` as a Chrome trace (`<host>_<pid>.<ns>.pt.trace.json`, which
  chrome://tracing, Perfetto and TensorBoard's profiler plugin read).
- `annotate(name)`: a named range in that trace (`record_function`) and,
  where CUDA is available, an NVTX range of the same name. PyTorch built
  without CUDA has no NVTX, so there the range is the trace's alone.
- `StepTimer`: wall-clock step statistics (mean, p50, p90), with
  `block_on` to wait for the device before a step's clock stops.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[profile]:
    """Profile the enclosed region into `logdir`."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range on the trace's timeline (and NVTX's, with CUDA)."""
    nvtx = torch.cuda.is_available()
    with record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def _tensors(tree) -> Iterator[torch.Tensor]:
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class StepTimer:
    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    def block_on(self, tree) -> None:
        """Wait for the device of every CUDA tensor in a nested list,
        tuple or dict before the step's clock stops."""
        for dev in {x.device for x in _tensors(tree) if x.is_cuda}:
            torch.cuda.synchronize(dev)

    def stats(self, skip_first: int = 1) -> Dict[str, float]:
        t = np.asarray(self.times[skip_first:] or self.times)
        return {"mean_s": float(t.mean()), "p50_s": float(np.percentile(t, 50)),
                "p90_s": float(np.percentile(t, 90)), "n": int(len(t))}
