"""Where the port's entry points run: the card unless the caller asks for
the CPU."""
from __future__ import annotations

import torch
import torch.nn as nn


def resolve_device(device=None) -> torch.device:
    """None means the card. A CUDA device without CUDA raises; the CPU is
    used only when asked for. A CUDA device without an index is the current
    one."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the "
                           "CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def require_on(dev: torch.device, **modules: nn.Module) -> None:
    """Raise unless every parameter of each module lies on `dev`; models are
    never moved behind the caller's back."""
    for name, module in modules.items():
        where = {p.device for p in module.parameters()}
        if where - {dev}:
            raise ValueError(
                f"{name} has parameters on {sorted(map(str, where))}, not on "
                f"{dev}; move it there first or pass its device")
