"""% of the profiled device time in kernels of no port kernel (serve)."""
from benchmark import readers  # noqa: F401


def read(run):
    return readers.plain_share(run, "serve")
