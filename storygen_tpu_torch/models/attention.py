"""VLCM transformer block: self-attention, text cross-attention, image
cross-attention and the GEGLU feed-forward.

Counterpart of storygen_tpu/models/attention.py. Every CrossAttention runs
through the flash kernels and every FeedForward through the fused GEGLU
kernel, forward and backward; projections stay plain matmuls. attn3 takes
an optional `ref_mask` (B, N refs) that drops reference frames from its kv
(the JAX `image_ref_mask`, stage-2 training's random 1-3 refs).

A module sharded by parallel/tensor.py holds its rank's heads (or inner
columns) and the tensor group (`tp`): its replicated inputs pass
Megatron's f, and its output projection's partial product (no bias) is
all-reduced in fp32 before the bias is added.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from storygen_tpu_torch.models.layers import Conv1x1, GroupNorm, linear
from storygen_tpu_torch.ops import route
from storygen_tpu_torch.ops.attention import multi_head_attention
from storygen_tpu_torch.ops.geglu import GegluMatmulFn, geglu_matmul_plain


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics, result in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class CrossAttention(nn.Module):
    """q/k/v projections without bias, output projection with bias."""

    tp = None  # the tensor group when sharded (parallel/tensor.py)

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        kv_dim = cross_attention_dim or query_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                ref_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.tp is not None:
            x = self.tp.copy_in(x)
            if context is not None:
                context = self.tp.copy_in(context)
        context = x if context is None else context
        out = multi_head_attention(
            linear(x, self.to_q), linear(context, self.to_k),
            linear(context, self.to_v), self.heads, ref_mask=ref_mask)
        if self.tp is None:
            return linear(out, self.to_out[0])
        lin = self.to_out[0]  # the partial product in fp32 of out's dtype
        return self.tp.reduce_out(
            F.linear(out.float(), lin.weight.to(out.dtype).float()),
            lin.bias.to(out.dtype), out.dtype)


class GEGLU(nn.Module):
    """The packed (dim -> 2*inner) projection [value | gate]."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)


class FeedForward(nn.Module):
    """net.0 (GEGLU projection) -> value*gelu(gate) -> net.2, with the gate
    and net.2 fused in the GEGLU kernel. Sharded, net.0 holds the rank's
    [value_r | gate_r] rows and net.2 its columns; kernel G computes the
    partial product without the bias."""

    tp = None  # the tensor group when sharded (parallel/tensor.py)

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = self.tp.copy_in(x)
        proj = linear(x, self.net[0].proj)
        out_lin = self.net[2]
        fn = route(GegluMatmulFn.apply, geglu_matmul_plain)
        bias = out_lin.bias if self.tp is None else torch.zeros_like(
            out_lin.bias)
        # the rows per image pick G's tile and split, never the batch
        out = fn(proj.reshape(-1, proj.shape[-1]),
                 out_lin.weight.to(proj.dtype), bias, x.shape[-2])
        if self.tp is not None:
            out = self.tp.reduce_out(out, out_lin.bias, proj.dtype)
        return out.reshape(*x.shape[:-1], out.shape[-1])


class BasicTransformerBlock(nn.Module):
    """attn1 -> [tap] -> (attn2 || attn3) -> sum -> FF. Returns
    (hidden_states, tap), the tap being the post-attn1 state."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 cross_attention_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads, head_dim)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, heads, head_dim, cross_attention_dim)
        self.norm4 = LayerNorm(dim)
        self.attn3 = CrossAttention(dim, heads, head_dim, dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, h: torch.Tensor, text: torch.Tensor,
                image: Optional[torch.Tensor] = None,
                ref_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`ref_mask` (B, N) keeps reference frames of `image`'s kv."""
        h = self.attn1(self.norm1(h)) + h
        tap = h
        h_t = self.attn2(self.norm2(h), text) + h
        if image is not None:
            h = h_t + (self.attn3(self.norm4(h), image, ref_mask) + h)
        else:
            h = h_t
        h = self.ff(self.norm3(h)) + h
        return h, tap


class Transformer2DModel(nn.Module):
    """GN -> 1x1 proj_in -> BasicTransformerBlock -> 1x1 proj_out +
    residual, over NHWC."""

    def __init__(self, heads: int, head_dim: int, in_channels: int,
                 cross_attention_dim: int, groups: int):
        super().__init__()
        inner = heads * head_dim
        self.norm = GroupNorm(groups, in_channels, eps=1e-6)
        self.proj_in = Conv1x1(in_channels, inner)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            inner, heads, head_dim, cross_attention_dim)])
        self.proj_out = Conv1x1(inner, in_channels)

    def forward(self, x: torch.Tensor, text: torch.Tensor,
                image: Optional[torch.Tensor] = None,
                ref_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, hh, ww, _ = x.shape
        h = self.proj_in(self.norm(x))
        h, tap = self.transformer_blocks[0](
            h.reshape(b, hh * ww, -1), text, image, ref_mask)
        return self.proj_out(h.reshape(b, hh, ww, -1)) + x, tap
