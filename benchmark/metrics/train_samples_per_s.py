"""Samples completed per second of the window (training cells)."""
from benchmark import readers  # noqa: F401


def read(run):
    return readers.rate(run, "train")
