"""Trainable-subset selection, learning-rate schedules and the optimizer.

Counterpart of storygen_tpu/training/optim.py. Freezing is by parameter
name: `partition_params` sets `requires_grad` from the stage's predicate and
returns the trainable parameters, so gradients and optimizer state exist for
those alone. The optimizer is the JAX package's
`chain(clip_by_global_norm, adamw)` under `MultiSteps`, with optax's
semantics, in plain fp32 torch (the JAX package leaves it to XLA, so no
kernel is involved):

- accumulation: the k micro-step gradients are averaged (a running mean);
  the parameters move once every k micro-steps;
- clipping: global norm over all trainable gradients; the gradients are
  left as they are below `max_grad_norm`, else scaled by max_norm / norm;
- AdamW: bias-corrected moments, eps outside the square root, decoupled
  weight decay on every trainable parameter, and the learning rate of the
  schedule at the number of updates made so far (0 for the first).

`make_optimizer` picks it or its 8-bit form (optim8bit.py, the JAX
package's `use_8bit_adam`), which shares all but the moments' storage.

Under tensor parallelism (parallel/tensor.py) some parameters are a
rank's shards of a tensor split over the tensor group (`sharded`): the
global norm then sums their squares over that group and counts every
other parameter once, as GSPMD computes it for the JAX package. The
moments of a shard are the shard's own; AdamW8bit quantises them in the
full tensor's blocks.
"""
from __future__ import annotations

import math
from typing import Callable, Collection, Dict, Iterable, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from storygen_tpu_torch.configs import TrainConfig

# stage1 finetunes self-attention only; stage2/COCO the VLCM image
# cross-attention only (reference train_StorySalon_stage{1,2}.py and
# train_COCO.py); "full" makes every UNet parameter trainable (the export
# names it and scripts/bench_train.py trains it with the stage-2 step;
# `trainer.train` runs the other three)
STAGE_PREDICATES: Dict[str, Callable[[str], bool]] = {
    "stage1": lambda name: "attn1" in name,
    "stage2": lambda name: "attn3" in name,
    "coco": lambda name: "attn3" in name,
    "full": lambda name: True,
}


def partition_params(module: nn.Module, predicate: Callable[[str], bool]
                     ) -> Dict[str, nn.Parameter]:
    """Freeze every parameter whose dotted name fails `predicate`; return
    the others, by name, with requires_grad set."""
    trainable = {}
    for name, p in module.named_parameters():
        keep = predicate(name)
        p.requires_grad_(keep)
        if keep:
            trainable[name] = p
    if not trainable:
        raise ValueError("the predicate selects no parameter")
    return trainable


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Learning rate as a function of the optimizer update count (optax's
    linear / cosine / warmup-then-constant schedules)."""
    lr = cfg.learning_rate
    if cfg.scale_lr:
        lr = lr * cfg.gradient_accumulation_steps * cfg.train_batch_size
    if cfg.lr_scheduler == "constant":
        warm = cfg.lr_warmup_steps
        if not warm:
            return lambda step: lr
        return lambda step: lr * min(step, warm) / warm
    if cfg.lr_scheduler == "linear":
        n = cfg.train_steps
        return lambda step: lr * (1.0 - min(max(step, 0), n) / n)
    if cfg.lr_scheduler == "cosine":
        n = cfg.train_steps
        return lambda step: lr * 0.5 * (1.0 + math.cos(math.pi * min(step, n)
                                                       / n))
    raise ValueError(cfg.lr_scheduler)


def lr_at(cfg: TrainConfig, opt_step: int) -> float:
    """Learning rate in effect at optimizer step `opt_step` (for logging)."""
    return float(make_schedule(cfg)(opt_step))


def global_norm(tensors: Iterable[torch.Tensor],
                sharded: Iterable[torch.Tensor] = (),
                group=None) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, fp32; the squares of
    `sharded` (a rank's shards of tensors split over the process group
    `group`) are summed over the group first."""
    total = sum(t.float().pow(2).sum() for t in tensors)
    shards = list(sharded)
    if shards:
        part = sum(t.float().pow(2).sum() for t in shards)
        dist.all_reduce(part, op=dist.ReduceOp.SUM, group=group)
        total = total + part
    return torch.sqrt(total)


class AdamW:
    """clip-by-global-norm -> AdamW -> k-step gradient accumulation over a
    {name: parameter} dict; all state in fp32 on the parameters' device.
    `state_dict` / `load_state_dict` carry the moments, the accumulator,
    `count` and `mini_step` (a checkpoint's optimizer state). `sharded`
    names the parameters that are shards over the process group
    `tp_group` (tensor parallelism)."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: TrainConfig,
                 sharded: Collection[str] = (), tp_group=None):
        self.params = params
        self.sharded = frozenset(sharded)
        self.tp_group = tp_group
        self.schedule = make_schedule(cfg)
        self.b1, self.b2 = cfg.adam_beta1, cfg.adam_beta2
        self.eps, self.weight_decay = cfg.adam_epsilon, cfg.adam_weight_decay
        self.max_norm = cfg.max_grad_norm
        self.every_k = max(cfg.gradient_accumulation_steps, 1)
        self.acc = {n: torch.zeros_like(p, dtype=torch.float32)
                    for n, p in params.items()}
        self.mu, self.nu = self._init_moments()
        self.count = 0       # optimizer updates made
        self.mini_step = 0   # micro-steps accumulated since the last update

    def _init_moments(self):
        return ({n: torch.zeros_like(a) for n, a in self.acc.items()},
                {n: torch.zeros_like(a) for n, a in self.acc.items()})

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> bool:
        """Accumulate one micro-step's gradients; every k-th call apply
        the update to the parameters in place. Returns whether it did."""
        n_acc = self.mini_step
        for name, g in grads.items():
            acc = self.acc[name]
            acc.add_((g.float() - acc) / (n_acc + 1))
        if n_acc < self.every_k - 1:
            self.mini_step += 1
            return False
        self._apply(self.acc)
        for acc in self.acc.values():
            acc.zero_()
        self.mini_step = 0
        return True

    def norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of a gradient of the parameters (sharded ones
        summed over the tensor group)."""
        return global_norm(
            (g for n, g in grads.items() if n not in self.sharded),
            (g for n, g in grads.items() if n in self.sharded),
            self.tp_group)

    def _apply(self, grads: Dict[str, torch.Tensor]) -> None:
        norm = self.norm(grads)
        below = norm < self.max_norm
        lr = self.schedule(self.count)  # the count before this update
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for name, p in self.params.items():
            g = grads[name]
            g = torch.where(below, g, g / norm * self.max_norm)
            self._step(name, p, g, lr, c1, c2)

    def _step(self, name: str, p: torch.Tensor, g: torch.Tensor, lr: float,
              c1: float, c2: float) -> None:
        """One parameter's AdamW update from its clipped gradient."""
        mu, nu = self.mu[name], self.nu[name]
        mu.mul_(self.b1).add_((1.0 - self.b1) * g)
        nu.mul_(self.b2).add_((1.0 - self.b2) * g * g)
        self._move(p, mu, nu, lr, c1, c2)

    def _move(self, p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
              lr: float, c1: float, c2: float) -> None:
        """p -= lr * (bias-corrected Adam step + weight decay), in fp32."""
        upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
        upd = upd + self.weight_decay * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "acc": self.acc, "mu": self.mu, "nu": self.nu}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore a state_dict in place, on the parameters' devices."""
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        mine = self.state_dict()
        for key in ("acc", "mu", "nu"):
            if set(state[key]) != set(mine[key]):
                raise KeyError(f"optimizer {key}: the state's tensors are not "
                               "the trainable parameters")
            for name, v in state[key].items():
                dst = mine[key][name]
                if isinstance(dst, dict):  # a quantized moment's parts
                    for part, t in dst.items():
                        t.copy_(v[part])
                else:
                    dst.copy_(v)


def make_optimizer(cfg: TrainConfig, params: Dict[str, torch.Tensor],
                   sharded: Optional[Mapping[str, object]] = None,
                   tp_group=None) -> AdamW:
    """AdamW, or with cfg.use_8bit_adam the block-quantized AdamW8bit
    (optim8bit.py); both clip, accumulate and schedule alike. `sharded`
    maps each parameter that is a shard over the process group `tp_group`
    to its parallel/tensor.py Shard: AdamW reads the names, AdamW8bit the
    Shards too."""
    if cfg.use_8bit_adam:
        from storygen_tpu_torch.training.optim8bit import AdamW8bit
        return AdamW8bit(params, cfg, sharded or {}, tp_group)
    return AdamW(params, cfg, sharded or {}, tp_group)
