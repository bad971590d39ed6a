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

Under tensor parallelism a rank holds shards of some parameters
(parallel/tensor.py). As GSPMD does for the JAX package, their moments
are quantised as the full tensor would be: blocks of 256 elements over
the full tensor's flat order, one absmax each. Each rank takes the
partial absmax of every block over the elements it holds, an all-reduce
MAX over the tensor group gives the block's scale, and the rank
quantises its own elements under it. A shard's QTensor keeps its values
in the shard's shape and the full tensor's scales (1/64 byte per element
of the full tensor on every rank); an update makes transient fp32
buffers of the full tensor's size, one tensor at a time.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from storygen_tpu_torch.parallel.tensor import (Shard, embed_shard,
                                                full_shape, take_shard)
from storygen_tpu_torch.training.optim import AdamW

BLOCK = 256


class QTensor(NamedTuple):
    q: torch.Tensor      # int8 / uint8 (n_blocks, BLOCK), or a shard's shape
    scale: torch.Tensor  # fp32 (n_blocks, 1), of the full tensor's blocks


class ShardOf(NamedTuple):
    """Where a rank's shard lies in its full tensor: the parameter's Shard,
    the rank's place in the tensor group, the group's size, the group."""
    shard: Shard
    rank: int
    size: int
    group: object


def _blocks(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)


def _shard_absmax(x: torch.Tensor, where: ShardOf,
                  signed: bool) -> torch.Tensor:
    """The full tensor's per-block absmax (n_blocks, 1), from every rank's
    shard x: each rank's partial maxima, all-reduced MAX over the group
    (the elements of other ranks are zeros here, which a max of absolute
    values, or of the non-negative second moment, ignores)."""
    blocks = _blocks(embed_shard(x, where.shard, where.rank, where.size))
    part = (blocks.abs() if signed else blocks).amax(dim=1, keepdim=True)
    dist.all_reduce(part, op=dist.ReduceOp.MAX, group=where.group)
    return part


def _on_shard(col: torch.Tensor, shape, where: ShardOf) -> torch.Tensor:
    """A per-block column (n_blocks, 1) of the full tensor, spread to the
    elements of the shard of shape `shape`."""
    full = full_shape(shape, where.shard, where.size)
    per_elem = col.expand(-1, BLOCK).reshape(-1)[:math.prod(full)]
    return take_shard(per_elem.reshape(full), where.shard, where.rank,
                      where.size)


def _quantize_shard(x: torch.Tensor, where: ShardOf, signed: bool
                    ) -> QTensor:
    """A shard's QTensor: its elements, in its shape, each quantized under
    its full-tensor block's scale, element for element as the unsharded
    quantizers do."""
    scale = _shard_absmax(x, where, signed)
    per_elem = _on_shard(scale.clamp_min(1e-30), x.shape, where)
    q = torch.round(x.float() / per_elem * (127.0 if signed else 255.0))
    return QTensor(q.to(torch.int8 if signed else torch.uint8), scale)


def quantize_signed(x: torch.Tensor,
                    where: Optional[ShardOf] = None) -> QTensor:
    if where is not None:
        return _quantize_shard(x, where, True)
    blocks = _blocks(x)
    scale = blocks.abs().amax(dim=1, keepdim=True)
    q = torch.round(blocks / scale.clamp_min(1e-30) * 127.0)
    return QTensor(q.to(torch.int8), scale)


def dequantize_signed(t: QTensor, shape,
                      where: Optional[ShardOf] = None) -> torch.Tensor:
    if where is not None:
        return t.q.float() * _on_shard(t.scale / 127.0, shape, where)
    blocks = t.q.float() * (t.scale / 127.0)
    return blocks.reshape(-1)[:shape.numel()].reshape(shape)


def quantize_unsigned(x: torch.Tensor,
                      where: Optional[ShardOf] = None) -> QTensor:
    if where is not None:
        return _quantize_shard(x, where, False)
    blocks = _blocks(x)
    scale = blocks.amax(dim=1, keepdim=True)
    q = torch.round(blocks / scale.clamp_min(1e-30) * 255.0)
    return QTensor(q.to(torch.uint8), scale)


def dequantize_unsigned(t: QTensor, shape,
                        where: Optional[ShardOf] = None) -> torch.Tensor:
    if where is not None:
        return t.q.float() * _on_shard(t.scale / 255.0, shape, where)
    blocks = t.q.float() * (t.scale / 255.0)
    return blocks.reshape(-1)[:shape.numel()].reshape(shape)


class AdamW8bit(AdamW):
    """AdamW whose moments live as QTensors (about 1.02 bytes per element
    each instead of 4). Under tensor parallelism `sharded` maps each
    sharded parameter's name to its Shard (parallel/tensor.py's plan), so
    that its moments take the full tensor's blocks."""

    def __init__(self, params, cfg, sharded=(), tp_group=None):
        self.where = {n: ShardOf(s, dist.get_rank(tp_group),
                                 dist.get_world_size(tp_group), tp_group)
                      for n, s in dict(sharded).items()}
        super().__init__(params, cfg, sharded, tp_group)

    def _init_moments(self):
        return ({n: quantize_signed(a, self.where.get(n))
                 for n, a in self.acc.items()},
                {n: quantize_unsigned(a, self.where.get(n))
                 for n, a in self.acc.items()})

    def _step(self, name, p, g, lr, c1, c2) -> None:
        where = self.where.get(name)
        m = (self.b1 * dequantize_signed(self.mu[name], g.shape, where)
             + (1.0 - self.b1) * g)
        n = (self.b2 * dequantize_unsigned(self.nu[name], g.shape, where)
             + (1.0 - self.b2) * g * g)
        self._move(p, m, n, lr, c1, c2)
        self.mu[name] = quantize_signed(m, where)
        self.nu[name] = quantize_unsigned(n, where)

    def state_dict(self) -> dict:
        """AdamW's, with each quantized moment as {"q", "scale"} (views of
        the moment's own tensors, which load_state_dict fills in place)."""
        def plain(moments):
            return {n: t._asdict() for n, t in moments.items()}
        return {"count": self.count, "mini_step": self.mini_step,
                "acc": self.acc, "mu": plain(self.mu), "nu": plain(self.nu)}
