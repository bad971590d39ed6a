"""% of the attention work's least time in F / M, L, DQ / DKV's time
(serve)."""
from benchmark import readers  # noqa: F401


def read(run):
    return readers.roofline(run, "serve", "attn")
