"""Frames completed per second of the window (serving cells)."""
from benchmark import readers  # noqa: F401


def read(run):
    return readers.rate(run, "serve")
