"""UNet and VAE building blocks over NHWC tensors.

Counterpart of storygen_tpu/models/layers.py. Parameter names and shapes
are the diffusers ones (OIHW conv weights, (out, in) linear weights), so a
diffusers state dict loads directly. Every 3x3 stride-1 convolution runs
through kernel C (`ops/conv.py`), but the one after a 2x upsampling, which
runs in its phase form on the source grid through kernel U
(`ops/upconv.py`), as the JAX package's `_UpsampleConv` does; stride-2
convolutions use F.conv2d, as the JAX package uses XLA's convolution
there. In the fused-conv configuration (`configs.ConvKernels`) a resnet's
convs take their GroupNorm + SiLU as kernel P's prologue, and stride-2
convolutions run kernel D (`ops/downconv.py`).

A resnet sharded by parallel/tensor.py holds its rank's conv1 output
channels (with time_emb_proj's and norm2's, whose groups it holds whole)
and conv2 input channels: conv1's replicated inputs pass Megatron's f, and
conv2's partial product, without bias and residual, is all-reduced in
fp32 before they are added.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from storygen_tpu_torch.ops import route
from storygen_tpu_torch.ops.conv import (Conv3x3Fn, GnConv3x3Fn,
                                         conv3x3_plain, gnconv3x3_plain,
                                         pack_weight)
from storygen_tpu_torch.ops.downconv import DownConv3x3Fn, downconv3x3_plain
from storygen_tpu_torch.ops.upconv import (UpConv3x3Fn, phase_weight,
                                           upsample_conv_plain)

Prologue = Tuple[torch.Tensor, torch.Tensor]


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           flip_sin_to_cos: bool = True,
                           downscale_freq_shift: float = 0.0,
                           max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding in fp32 (diffusers Timesteps)."""
    half = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    emb = torch.exp(exponent / (half - downscale_freq_shift))
    emb = timesteps.float()[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """`layer` applied in x's dtype: a trained layer keeps fp32
    parameters while the model computes in bf16."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


class TimestepEmbedding(nn.Module):
    """linear_1 -> SiLU -> linear_2."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return linear(F.silu(linear(sample, self.linear_1)), self.linear_2)


class GroupNorm(nn.Module):
    """GroupNorm over NHWC (or (B, S, C)) with fp32 statistics; the result
    is cast back to the input dtype. `act="silu"` applies SiLU after."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5,
                 act: Optional[str] = None):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        g = self.num_groups
        xf = x.float().reshape(b, -1, g, c // g)
        var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True,
                                   correction=0)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        y = y * self.weight.float() + self.bias.float()
        if self.act == "silu":
            y = F.silu(y)
        return y.to(x.dtype)

    def fold(self, x: torch.Tensor) -> Prologue:
        """The normalisation folded with the affine into per-(batch,
        channel) fp32 (a, s), differentiable, so that forward(x) is x * a +
        s (then the act); the consumer applies it (kernel P's prologue).
        Counterpart of the JAX GroupNorm's fold_affine=True."""
        b, c = x.shape[0], x.shape[-1]
        g = self.num_groups
        var, mean = torch.var_mean(x.float().reshape(b, -1, g, c // g),
                                   dim=(1, 3), correction=0)       # (B, g)
        a = (torch.rsqrt(var + self.eps).repeat_interleave(c // g, dim=1)
             * self.weight.float())
        s = self.bias.float() - mean.repeat_interleave(c // g, dim=1) * a
        return a, s


class Conv1x1(nn.Module):
    """1x1 convolution over the channel axis (diffusers Conv2d(k=1))."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 1, 1))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0, 0].to(x.dtype),
                        self.bias.to(x.dtype))


class _Packed3x3(nn.Module):
    """A 3x3 conv's OIHW weight and bias, and the weight packed for the
    kernels: as (9, Cin, Cout) (`packed_weight`) and as the (16, Cin, Cout)
    phase weights of a 2x upsampling's conv (`phase_packed_weight`). While
    no gradient can flow to the weight (it does not require grad, or grad
    mode is off), each packing is cached and rebuilt when the weight
    changes; otherwise it is packed at every call, differentiably."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self._packed = {}  # packing -> (the weight's key, the packed weight)

    def _pack(self, pack, dtype: torch.dtype) -> torch.Tensor:
        w = self.weight
        if w.requires_grad and torch.is_grad_enabled():
            return pack(w, dtype)
        key = (w.data_ptr(), w._version, w.device, dtype)
        if self._packed.get(pack, (None,))[0] != key:
            self._packed[pack] = (key, pack(w.detach(), dtype))
        return self._packed[pack][1]

    def packed_weight(self, dtype: torch.dtype) -> torch.Tensor:
        return self._pack(pack_weight, dtype)

    def phase_packed_weight(self, dtype: torch.dtype) -> torch.Tensor:
        return self._pack(phase_weight, dtype)


class Conv3x3(_Packed3x3):
    """3x3 stride-1 SAME convolution through kernel C, or through kernel P
    when given a prologue."""

    def forward(self, x: torch.Tensor,
                extra_bias: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None,
                prologue: Optional[Prologue] = None,
                with_bias: bool = True) -> torch.Tensor:
        """`extra_bias` (B, Cout) is added with the bias (the resnet temb
        term); `residual` (B, H, W, Cout) is added to the output;
        `prologue` (a, s), each (B, Cin) fp32, applies silu(x * a + s) to
        the input first (a folded GroupNorm + SiLU); without `with_bias`
        the bias is left out (a row-parallel partial product)."""
        bias = self.bias.float() if with_bias else torch.zeros_like(
            self.bias, dtype=torch.float32)
        if extra_bias is not None:
            bias = bias[None] + extra_bias.float()
        w9 = self.packed_weight(x.dtype)
        res = None if residual is None else residual.contiguous()
        if prologue is None:
            fn = route(Conv3x3Fn.apply, conv3x3_plain)
            return fn(x.contiguous(), w9, bias, res)
        a, s = prologue
        fn = route(GnConv3x3Fn.apply, gnconv3x3_plain)
        return fn(x.contiguous(), w9, bias, a, s, res)


class StridedConv(_Packed3x3):
    """3x3 stride-2 convolution with explicit (top, bottom, left, right)
    zero padding over NHWC: F.conv2d, or kernel D with `strided`."""

    def __init__(self, cin: int, cout: int, pad=(1, 1, 1, 1),
                 strided: bool = False):
        super().__init__(cin, cout)
        self.pad, self.strided = pad, strided

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.strided:
            fn = route(DownConv3x3Fn.apply, downconv3x3_plain)
            return fn(x.contiguous(), self.packed_weight(x.dtype),
                      self.bias.float(), self.pad)
        t, bo, le, ri = self.pad
        xc = F.pad(x.permute(0, 3, 1, 2), (le, ri, t, bo))
        y = F.conv2d(xc, self.weight.to(x.dtype), self.bias.to(x.dtype),
                     stride=2)
        return y.permute(0, 2, 3, 1).contiguous()


class ResnetBlock2D(nn.Module):
    """GN -> SiLU -> conv1 (+temb) -> GN -> SiLU -> conv2 (+ shortcut).
    With temb_channels=None it is the VAE's resnet (no time embedding).
    With `fused_prologue` each GN + SiLU is folded into (a, s) and applied
    by its conv's prologue (kernel P), as the JAX ResnetBlock2D does."""

    tp = None  # the tensor group when sharded (parallel/tensor.py)

    def __init__(self, cin: int, cout: int, groups: int, eps: float,
                 temb_channels: Optional[int] = None,
                 fused_prologue: bool = False):
        super().__init__()
        self.fused_prologue = fused_prologue
        self.norm1 = GroupNorm(groups, cin, eps, act="silu")
        self.conv1 = Conv3x3(cin, cout)
        if temb_channels is not None:
            self.time_emb_proj = nn.Linear(temb_channels, cout)
        self.norm2 = GroupNorm(groups, cout, eps, act="silu")
        self.conv2 = Conv3x3(cout, cout)
        if cin != cout:
            self.conv_shortcut = Conv1x1(cin, cout)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        tp = self.tp
        extra = None
        if temb is not None:
            t = F.silu(temb)
            extra = linear(t if tp is None else tp.copy_in(t),
                           self.time_emb_proj)
        skip = self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x
        if self.fused_prologue:
            a, s = self.norm1.fold(x)
            xin = x
            if tp is not None:
                xin, a, s = tp.copy_in(x, a, s)
            h = self.conv1(xin, extra_bias=extra, prologue=(a, s))
            if tp is None:
                return self.conv2(h, residual=skip,
                                  prologue=self.norm2.fold(h))
            part = self.conv2(h, prologue=self.norm2.fold(h), with_bias=False)
        else:
            hin = self.norm1(x)
            h = self.conv1(hin if tp is None else tp.copy_in(hin),
                           extra_bias=extra)
            if tp is None:
                return self.conv2(self.norm2(h), residual=skip)
            part = self.conv2(self.norm2(h), with_bias=False)
        return tp.reduce_out(part, self.conv2.bias, x.dtype, skip)


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv, padding (1, 1, 1, 1) in the UNet and (0, 1, 0, 1)
    in the VAE encoder, held as `.conv`; kernel D with `strided`."""

    def __init__(self, channels: int, pad=(1, 1, 1, 1),
                 strided: bool = False):
        super().__init__()
        self.conv = StridedConv(channels, channels, pad, strided)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UpsampleConv(_Packed3x3):
    """A 3x3 SAME conv of x's nearest 2x upsampling, as the four phase
    convs on x's grid (kernel U); the parameters are the 3x3 conv's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = route(UpConv3x3Fn.apply, upsample_conv_plain)
        return fn(x.contiguous(), self.packed_weight(x.dtype),
                  self.bias.float(), self.phase_packed_weight(x.dtype))


class Upsample2D(nn.Module):
    """Nearest 2x upsample, then a 3x3 conv (held as `.conv`), computed in
    the phase form of the JAX package's 2x branch (`_UpsampleConv`)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = UpsampleConv(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)
