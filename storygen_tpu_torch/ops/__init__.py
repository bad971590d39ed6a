"""Kernels of the port and their plain PyTorch versions.

Each kernel module (`flash_attention`, `geglu`, `conv`) holds a wrapper
that launches the CUDA kernel for a CUDA tensor, or calls the plain version
for a CPU tensor, and counts its launches in `<wrapper>.launches`.

The models reach the kernels through `route(kernel, plain)`, which returns
the wrapper unless `plain_path()` is active. `plain_path()` exists for one
purpose: running a whole model through the plain versions on the card, as
the oracle that the kernel path is compared against.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator

_plain = False


@contextlib.contextmanager
def plain_path() -> Iterator[None]:
    """Route every kernel site of the models to its plain version."""
    global _plain
    prev, _plain = _plain, True
    try:
        yield
    finally:
        _plain = prev


def route(kernel: Callable, plain: Callable) -> Callable:
    return plain if _plain else kernel
