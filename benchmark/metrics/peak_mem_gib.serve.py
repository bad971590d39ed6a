"""GiB: torch.cuda.max_memory_allocated over warm-up and window (serve)."""
from benchmark import readers  # noqa: F401


def read(run):
    return readers.peak_gib(run, "serve")
