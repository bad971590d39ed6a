"""% of the 989 TFLOP/s bf16 peak in the window's model FLOPs (serve)."""
from benchmark import readers  # noqa: F401


def read(run):
    return readers.mfu(run, "serve")
