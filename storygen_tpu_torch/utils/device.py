"""Where the port's entry points run: the card unless the caller asks for
the CPU; and what nvidia-smi says of that card."""
from __future__ import annotations

import subprocess

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


def card_facts(dev: torch.device) -> dict:
    """The facts that every timing line carries, read (never set) by
    nvidia-smi for the card behind `dev`: "card", its name and power limit
    as `--query-gpu=name,power.limit --format=csv,noheader` prints them,
    and "sm_clock", its SM clock at the time of the call. On the CPU:
    {"device": "cpu"} alone."""
    if dev.type != "cuda":
        return {"device": "cpu"}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    rows = [[f.strip() for f in line.split(",")]
            for line in out.strip().splitlines()]
    uuid = str(getattr(torch.cuda.get_device_properties(dev), "uuid", ""))
    mine = [r for r in rows if uuid and r[0].removeprefix("GPU-")
            == uuid.removeprefix("GPU-")]
    if not mine and len(rows) == 1:  # one card: it is the one
        mine = rows
    if len(mine) != 1:
        raise RuntimeError(f"nvidia-smi lists no card with the uuid {uuid!r}"
                           f" of {dev}: {rows}")
    _, name, limit, clock = mine[0]
    return {"device": torch.cuda.get_device_name(dev),
            "card": f"{name}, {limit}", "sm_clock": clock}


def facts_tag(facts: dict) -> str:
    """card_facts' dict as the tag that ends a printed line: [k v, ...]."""
    return "[" + ", ".join(f"{k} {v}" for k, v in facts.items()) + "]"
