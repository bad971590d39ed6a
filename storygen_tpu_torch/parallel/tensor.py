"""Tensor parallelism for the UNet and the VAE over a (data, tensor) mesh.

Counterpart of storygen_tpu/parallel/tensor.py, Megatron's column / row
split. The JAX package states the split as placement rules and lets GSPMD
insert the collectives; the port shards each module's parameters in place
and issues Megatron's two operators itself (`TensorParallel.copy_in`, f:
identity forward, all-reduce backward; `reduce`, g: all-reduce forward,
identity backward):

- attention q/k/v: column split, so the heads shard over "tensor"; the
  output projection: row split, its partial product all-reduced;
- the feed-forward's GEGLU projection (net.0.proj): column split of each
  half of its packed [value | gate] rows, so that rank r holds [value_r |
  gate_r] and kernel G still takes (M, 2n); net.2: row split;
- resnet conv1 and time_emb_proj: output-channel split; norm2 (between
  the convs) on the rank's channels, which must hold whole groups (320 /
  32 = 10 channels per group at SD-1.5: whole groups for tp <= 8); conv2:
  input-channel split, its partial product all-reduced;
- the VAE mid block's single-head attention: query / key / value split
  over channels, the fp32 logits all-reduced before the softmax (the scale
  stays that of the full channel count), proj_attn row split;
- everything else replicated: embeddings, conv_in / conv_out, proj_in /
  proj_out, shortcuts, the norms on replicated activations, CLIP.

A row-parallel partial product carries no bias and no residual: it is
all-reduced in fp32, then the bias and the residual are added once. The
specs give each sharded dimension in torch layout (Linear (out, in), conv
OIHW), JAX's Dense dim 1 and HWIO dim 3 being the port's dim 0. As in
JAX, a parameter whose dimension the tensor size does not divide stays
replicated (its module with it); unlike GSPMD, the port raises where a
shard would cut a GroupNorm group or an attention head.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from storygen_tpu_torch.parallel.mesh import (DATA_AXIS, TENSOR_AXIS, Mesh,
                                              replicate, shard_batch)


class Shard(NamedTuple):
    """How a parameter splits: along `dim`, contiguously (halves 1) or
    each of its `halves` equal parts split alike and the rank's parts
    concatenated (the GEGLU projection's [value | gate])."""
    dim: int
    halves: int = 1


def make_tp_mesh(data: int, tensor: int) -> Mesh:
    return Mesh((data, tensor), (DATA_AXIS, TENSOR_AXIS))


def unet_param_spec(name: str, shape: Tuple[int, ...]) -> Optional[Shard]:
    """The split of one UNet parameter (diffusers name), None if
    replicated."""
    p = name.split(".")
    leaf, owner = p[-1], p[-2] if len(p) >= 2 else ""
    weight = leaf == "weight"
    if any(s.startswith("attn") for s in p):
        if owner in ("to_q", "to_k", "to_v"):
            return Shard(0)
        if p[-3:-1] == ["to_out", "0"]:
            return Shard(1) if weight else None
    if "ff" in p:
        if owner == "proj":  # GEGLU packed (2*inner, C)
            return Shard(0, halves=2)
        if p[-3:-1] == ["net", "2"]:
            return Shard(1) if weight else None
    if owner in ("conv1", "time_emb_proj"):
        return Shard(0)
    if owner == "conv2":
        return Shard(1) if weight else None
    if owner == "norm2" and "resnets" in p:  # between conv1 and conv2
        return Shard(0)
    return None


def vae_param_spec(name: str, shape: Tuple[int, ...]) -> Optional[Shard]:
    """The split of one VAE parameter: the mid block attention's
    query / key / value by output channel, proj_attn by input channel; its
    group_norm (on the replicated input) replicated; the resnets by the
    UNet's rules, which key on the shared names."""
    p = name.split(".")
    owner = p[-2] if len(p) >= 2 else ""
    if owner in ("query", "key", "value"):
        return Shard(0)
    if owner == "proj_attn":
        return Shard(1) if p[-1] == "weight" else None
    if owner == "group_norm":
        return None
    return unet_param_spec(name, shape)


def take_shard(x: torch.Tensor, shard: Shard, rank: int,
               size: int) -> torch.Tensor:
    """Rank `rank`'s part of the full tensor x."""
    part = x.shape[shard.dim] // shard.halves
    k = part // size
    return torch.cat([x.narrow(shard.dim, h * part + rank * k, k)
                      for h in range(shard.halves)], shard.dim).contiguous()


def full_shape(shape, shard: Shard, size: int) -> Tuple[int, ...]:
    """The full tensor's shape, from the shape of a shard of it."""
    out = list(shape)
    out[shard.dim] *= size
    return tuple(out)


def embed_shard(t: torch.Tensor, shard: Shard, rank: int,
                size: int) -> torch.Tensor:
    """The inverse of take_shard on one rank: rank `rank`'s part t in a
    zeroed fp32 tensor of the full shape."""
    full = torch.zeros(full_shape(t.shape, shard, size), dtype=torch.float32,
                       device=t.device)
    part = full.shape[shard.dim] // shard.halves
    k = t.shape[shard.dim] // shard.halves
    for h in range(shard.halves):
        full.narrow(shard.dim, h * part + rank * k, k).copy_(
            t.narrow(shard.dim, h * k, k))
    return full


def _divides(shape, shard: Shard, size: int) -> bool:
    return shape[shard.dim] % (shard.halves * size) == 0


class _CopyIn(torch.autograd.Function):
    """Megatron's f: identity forward; the gradients all-reduced."""

    @staticmethod
    def forward(ctx, tp, *xs):
        ctx.tp = tp
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g in grads:
            if g is not None:
                g = g.contiguous().clone()
                dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.tp.group)
            out.append(g)
        return (None, *out)


class _Reduce(torch.autograd.Function):
    """Megatron's g: all-reduce forward (fp32); identity backward."""

    @staticmethod
    def forward(ctx, tp, x):
        y = x.float().contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=tp.group)
        tp.allreduces += 1
        return y

    @staticmethod
    def backward(ctx, g):
        return None, g


class TensorParallel:
    """The tensor group that a sharded model's modules share: its size,
    this rank's place in it, and the forward all-reduces made so far
    (`allreduces`, one per row-parallel site and VAE attention logits)."""

    def __init__(self, mesh: Mesh):
        self.group = mesh.group(TENSOR_AXIS)
        self.size = mesh.size(TENSOR_AXIS)
        self.rank = mesh.index(TENSOR_AXIS)
        self.allreduces = 0

    def copy_in(self, *xs: torch.Tensor):
        """f on the replicated inputs of a column-parallel region."""
        out = _CopyIn.apply(self, *xs)
        return out if len(xs) > 1 else out[0]

    def reduce(self, partial: torch.Tensor) -> torch.Tensor:
        """g: the sum of every rank's partial product, in fp32."""
        return _Reduce.apply(self, partial)

    def reduce_out(self, partial: torch.Tensor,
                   bias: Optional[torch.Tensor], dtype: torch.dtype,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A row-parallel site's output: the partial products summed in
        fp32, then the bias and the residual added once, in `dtype`."""
        y = self.reduce(partial)
        if bias is not None:
            y = y + bias.float()
        if residual is not None:
            y = y + residual.float()
        return y.to(dtype)


def _units(model: nn.Module):
    """The modules that hold a split (their forward takes it over), by
    name."""
    from storygen_tpu_torch.models.attention import (CrossAttention,
                                                     FeedForward)
    from storygen_tpu_torch.models.layers import ResnetBlock2D
    from storygen_tpu_torch.models.vae import VAEAttentionBlock
    kinds = (CrossAttention, FeedForward, ResnetBlock2D, VAEAttentionBlock)
    return [(n, m) for n, m in model.named_modules() if isinstance(m, kinds)]


def shard_plan(model: nn.Module, spec: Callable, size: int
               ) -> Dict[str, Shard]:
    """{parameter name: Shard} of the parameters that shard over `size`
    ranks. A module whose split dimensions `size` does not divide stays
    replicated; one whose shard would cut an attention head or a GroupNorm
    group raises, naming the parameter."""
    from storygen_tpu_torch.models.attention import CrossAttention
    from storygen_tpu_torch.models.layers import ResnetBlock2D
    plan: Dict[str, Shard] = {}
    if size == 1:
        return plan
    for prefix, unit in _units(model):
        mine = {}
        for n, p in unit.named_parameters():
            s = spec(f"{prefix}.{n}", tuple(p.shape))
            if s is not None:
                mine[f"{prefix}.{n}"] = (s, p.shape)
        if not mine or not all(_divides(shape, s, size)
                               for s, shape in mine.values()):
            continue
        if isinstance(unit, CrossAttention) and unit.heads % size:
            raise ValueError(f"{prefix}.to_q.weight: {unit.heads} heads do "
                             f"not split over {size} ranks")
        if isinstance(unit, ResnetBlock2D) and unit.norm2.num_groups % size:
            c = unit.norm2.weight.shape[0]
            raise ValueError(
                f"{prefix}.norm2.weight: a shard of {c // size} of its {c} "
                f"channels cuts its groups of {c // unit.norm2.num_groups}")
        plan.update({n: s for n, (s, _) in mine.items()})
    return plan


@torch.no_grad()
def _shard_model(model: nn.Module, mesh: Mesh,
                 spec: Callable) -> Optional[TensorParallel]:
    """Replace every sharded parameter by this rank's part and hand the
    modules holding them the tensor group; the plan and the group are kept
    as `model.tp_plan` and `model.tp`."""
    tp = TensorParallel(mesh)
    plan = shard_plan(model, spec, tp.size)
    params = dict(model.named_parameters())
    for name, s in plan.items():
        p = params[name]
        p.data = take_shard(p.data, s, tp.rank, tp.size)
    for prefix, unit in _units(model):
        if any(n.startswith(prefix + ".") for n in plan):
            unit.tp = tp
            if hasattr(unit, "heads"):
                unit.heads //= tp.size
            if hasattr(unit, "norm2"):
                unit.norm2.num_groups //= tp.size
    model.tp_plan = plan
    model.tp = tp if plan else None
    return model.tp


def shard_unet_params(unet: nn.Module, mesh: Mesh
                      ) -> Optional[TensorParallel]:
    """Shard the UNet in place per unet_param_spec; returns the tensor
    group its modules share (None if nothing sharded)."""
    return _shard_model(unet, mesh, unet_param_spec)


def shard_vae_params(vae: nn.Module, mesh: Mesh) -> Optional[TensorParallel]:
    """Shard the VAE in place per vae_param_spec."""
    return _shard_model(vae, mesh, vae_param_spec)


def replicated_on(mesh: Mesh, tree):
    """Rank 0's values of a replicated tree (modules or tensors) on every
    rank of the mesh."""
    return replicate(tree, mesh)


@torch.no_grad()
def tp_place(tensors: Dict[str, torch.Tensor], plan: Dict[str, Shard],
             tp: TensorParallel) -> Dict[str, torch.Tensor]:
    """Full tensors keyed by parameter name (parameters, or optimizer
    moments, which share their names) -> this rank's shards per `plan`;
    names outside the plan stay whole. A resumed run takes its shards from
    a checkpoint's full tensors so."""
    return {n: take_shard(t, plan[n], tp.rank, tp.size) if n in plan else t
            for n, t in tensors.items()}


@torch.no_grad()
def full_tensors(tensors: Dict[str, torch.Tensor], plan: Dict[str, Shard],
                 tp: TensorParallel) -> Dict[str, torch.Tensor]:
    """The inverse of tp_place, on every rank of the tensor group: each
    shard embedded in a zeroed full tensor, then summed over the group
    (exact: every element has one non-zero term). A collective: every
    rank calls it with the same names."""
    out = {}
    for n, t in tensors.items():
        s = plan.get(n)
        if s is None:
            out[n] = t.detach()
            continue
        full = embed_shard(t, s, tp.rank, tp.size)
        dist.all_reduce(full, op=dist.ReduceOp.SUM, group=tp.group)
        out[n] = full.to(t.dtype)
    return out


# The batch splits over "data" only: every tensor rank of a data slice
# sees the same rows (the mesh's batch axes leave "tensor" out).
tp_shard_batch = shard_batch


def make_train_step_tp(bundle: dict, cfg, mesh: Mesh, stage: str = "stage2",
                       **step_kw):
    """The training step on a (data, tensor) mesh: the UNet sharded in
    place, the stage's subset made trainable in fp32, the optimizer built
    on the shards (its moments are the shards' own, its norm sums the
    shards over the tensor group, and AdamW8bit's blocks are the full
    tensor's) and the step averaging gradients over "data". `bundle`
    holds unet, vae, text_encoder and scheduler_config
    (trainer.build_models); the VAE and CLIP stay replicated. Returns
    (step_fn, optimizer)."""
    from storygen_tpu_torch.diffusion import schedule as S
    from storygen_tpu_torch.training import optim, steps
    unet = bundle["unet"]
    tp = shard_unet_params(unet, mesh)
    for m in (bundle["vae"], bundle["text_encoder"]):
        m.requires_grad_(False)
    trainable = optim.partition_params(unet, optim.STAGE_PREDICATES[stage])
    for p in trainable.values():
        p.data = p.data.float()
    opt = optim.make_optimizer(
        cfg, trainable, {n: unet.tp_plan[n] for n in trainable
                         if n in unet.tp_plan},
        None if tp is None else tp.group)
    sched = S.make_schedule(bundle["scheduler_config"],
                            device=next(unet.parameters()).device)
    step = steps.make_train_step(unet, bundle["vae"], bundle["text_encoder"],
                                 sched, opt, stage=stage, mesh=mesh,
                                 **step_kw)
    return step, opt
