"""Training checkpoints: save, find the latest, restore.

Counterpart of storygen_tpu/checkpoint/orbax_io.py on `torch.save`. Each
save writes `<ckpt_dir>/<step>/state.pt` under a temporary name and renames
the folder into place, so a run killed mid-save leaves no half checkpoint
that `latest_step` would pick. The state is a nested dict of tensors and
Python scalars (the trainer's: the micro-step count, which is also the
loader's position, the trainable tensors, the optimizer's state and the
generator's state);
tensors are stored on the CPU and restored there, bit for bit.
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"


def _to_cpu(x: Any) -> Any:
    if torch.is_tensor(x):
        return x.detach().to("cpu")
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def save_checkpoint(ckpt_dir: str, step: int, state: Any) -> str:
    """Write `state` as checkpoint `step`; returns its folder."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    final = os.path.join(ckpt_dir, str(step))
    tmp = os.path.join(ckpt_dir, f".tmp-{step}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(_to_cpu(state), os.path.join(tmp, STATE_FILE))
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest step with a complete checkpoint, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir) if d.isdigit()
             and os.path.isfile(os.path.join(ckpt_dir, d, STATE_FILE))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None) -> Any:
    """The state saved as `step` (the latest if None), tensors on the
    CPU."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(os.path.abspath(ckpt_dir), str(step), STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)
