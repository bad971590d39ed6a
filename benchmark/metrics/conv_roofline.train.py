"""% of the 3x3 convolutions' least time in C, P, D, U, UB's and the
library convolutions' time (train)."""
from benchmark import readers  # noqa: F401


def read(run):
    return readers.roofline(run, "train", "conv")
