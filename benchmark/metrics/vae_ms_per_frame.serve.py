"""Milliseconds of the references' VAE encode and the decode per frame,
by CUDA events around the two calls in each call of the traced window."""
from benchmark import readers  # noqa: F401


def read(run):
    return run["vae_ms"] if run["job"] == "serve" else None
