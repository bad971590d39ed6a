"""A whole run of a cell on the CPU at tiny widths in float32: the
harness without its look for a card."""
import torch

from benchmark.core import Bench
from benchmark.run import Run
from benchmark.tests.tiny import tiny_cell

BATCH = {"story-frame-3ref-b4": 2, "story-frame-noref-b8": 2,
         "train-stage2-b12": 4}
CELLS = sorted(BATCH)
SERVING = ["story-frame-3ref-b4", "story-frame-noref-b8"]


def cpu_run(cell: str, seed: int = 2 ** 33 + 7) -> Run:
    torch.set_num_threads(2)
    cfg, traffic = tiny_cell(cell, BATCH[cell])
    return Run(Bench(), cell, seed, 0.0, False, "cpu", cfg, traffic,
               torch.float32)
