"""Seeded random initialisation for runs without checkpoint files."""
from __future__ import annotations

import torch
import torch.nn as nn


@torch.no_grad()
def init_random_(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from one seeded generator on its device:
    biases 0, norm scales 1, embeddings N(0, 0.02^2), other weights
    N(0, 1/fan_in) (lecun normal, as the JAX package initialises)."""
    gens = {}
    for name, p in module.named_parameters():
        if p.device not in gens:
            gens[p.device] = torch.Generator(device=p.device).manual_seed(seed)
        g = gens[p.device]
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias":
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        elif "embedding" in name:
            p.copy_(torch.randn(p.shape, generator=g, device=p.device) * 0.02)
        else:
            fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=g, device=p.device)
                    * fan_in ** -0.5)
    return module
