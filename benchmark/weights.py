"""Seeded weights, made on the device in a few large calls.

The benchmark, not the program, makes every weight: for each model one
`torch.randn` over all its parameters at once, on a generator on the card
seeded from the run's seed, in the dtype the model is served in; then
each parameter is a slice of that draw: biases 0, norm scales 1,
embeddings N(0, 0.02^2), other weights N(0, 1/fan_in) (lecun normal, the
port's and the JAX package's random initialisation). `make` is
deterministic, so the reference rebuilds the same tensors from the seed
after the program's state is freed, and reads them in float32.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

Spec = Iterable[Tuple[str, Tuple[int, ...]]]


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit generator seed for (seed, *path): any whole number seed,
    however large."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             *(int(p) for p in path)]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> 1)


@torch.no_grad()
def make(spec: Spec, seed: int, dtype: torch.dtype, device
         ) -> Dict[str, torch.Tensor]:
    """{name: tensor} for `spec` [(name, shape)], from one draw."""
    spec = list(spec)
    total = sum(int(np.prod(s)) for _, s in spec)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device, dtype=dtype)
    out, off = {}, 0
    for name, shape in spec:
        n = int(np.prod(shape))
        w = flat[off:off + n].view(shape)
        off += n
        if name.rsplit(".", 1)[-1] == "bias":
            w.zero_()
        elif len(shape) == 1:
            w.fill_(1.0)
        elif "embedding" in name:
            w.mul_(0.02)
        else:
            w.mul_(float(np.prod(shape[1:])) ** -0.5)
        out[name] = w
    return out


def spec_of(module: torch.nn.Module) -> list:
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]


@torch.no_grad()
def fill(module: torch.nn.Module, seed: int, device,
         dtype: torch.dtype = torch.bfloat16) -> torch.nn.Module:
    """Give a module built on the meta device storage on `device` and the
    seeded weights in `dtype`: every parameter becomes a view of one
    draw."""
    module.to_empty(device=device)
    weights = make(spec_of(module), seed, dtype, device)
    for name, p in module.named_parameters():
        p.data = weights[name]
    return module
