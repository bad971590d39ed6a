"""AdamW with block-quantized 8-bit moments.

Counterpart of storygen_tpu/training/optim8bit.py (the reference's
bnb.optim.AdamW8bit flag), in plain torch: the JAX package computes it
with XLA, so there is no kernel to port. Each moment is stored in blocks
of 256 elements with one fp32 absmax scale per block: the first moment as
signed int8 in [-127, 127], the second (non-negative) as uint8 in
[0, 255], rounded half to even. Every update dequantizes, updates in fp32
and requantizes. Clipping, accumulation and the schedule are AdamW's
(training/optim.py); the learning rate is the schedule's at the number of
updates made before this one, as in AdamW and optax's adamw.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from storygen_tpu_torch.training.optim import AdamW

BLOCK = 256


class QTensor(NamedTuple):
    q: torch.Tensor      # int8 / uint8 (n_blocks, BLOCK)
    scale: torch.Tensor  # fp32 (n_blocks, 1)


def _blocks(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)


def quantize_signed(x: torch.Tensor) -> QTensor:
    blocks = _blocks(x)
    scale = blocks.abs().amax(dim=1, keepdim=True)
    q = torch.round(blocks / scale.clamp_min(1e-30) * 127.0)
    return QTensor(q.to(torch.int8), scale)


def dequantize_signed(t: QTensor, shape) -> torch.Tensor:
    blocks = t.q.float() * (t.scale / 127.0)
    return blocks.reshape(-1)[:shape.numel()].reshape(shape)


def quantize_unsigned(x: torch.Tensor) -> QTensor:
    blocks = _blocks(x)
    scale = blocks.amax(dim=1, keepdim=True)
    q = torch.round(blocks / scale.clamp_min(1e-30) * 255.0)
    return QTensor(q.to(torch.uint8), scale)


def dequantize_unsigned(t: QTensor, shape) -> torch.Tensor:
    blocks = t.q.float() * (t.scale / 255.0)
    return blocks.reshape(-1)[:shape.numel()].reshape(shape)


class AdamW8bit(AdamW):
    """AdamW whose moments live as QTensors (about 1.02 bytes per element
    each instead of 4)."""

    def _init_moments(self):
        return ({n: quantize_signed(a) for n, a in self.acc.items()},
                {n: quantize_unsigned(a) for n, a in self.acc.items()})

    def _step(self, name, p, g, lr, c1, c2) -> None:
        m = (self.b1 * dequantize_signed(self.mu[name], g.shape)
             + (1.0 - self.b1) * g)
        n = (self.b2 * dequantize_unsigned(self.nu[name], g.shape)
             + (1.0 - self.b2) * g * g)
        self._move(p, m, n, lr, c1, c2)
        self.mu[name] = quantize_signed(m)
        self.nu[name] = quantize_unsigned(n)

    def state_dict(self) -> dict:
        """AdamW's, with each quantized moment as {"q", "scale"} (views of
        the moment's own tensors, which load_state_dict fills in place)."""
        def plain(moments):
            return {n: t._asdict() for n, t in moments.items()}
        return {"count": self.count, "mini_step": self.mini_step,
                "acc": self.acc, "mu": plain(self.mu), "nu": plain(self.nu)}
