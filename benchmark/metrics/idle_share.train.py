"""% of the profiled stretch's wall time with the device idle (train)."""
from benchmark import readers  # noqa: F401


def read(run):
    return readers.idle_share(run, "train")
