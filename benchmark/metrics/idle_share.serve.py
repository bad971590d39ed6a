"""% of the profiled stretch's wall time with the device idle (serve)."""
from benchmark import readers  # noqa: F401


def read(run):
    return readers.idle_share(run, "serve")
