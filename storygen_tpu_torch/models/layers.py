"""UNet and VAE building blocks over NHWC tensors.

Counterpart of storygen_tpu/models/layers.py. Parameter names and shapes
are the diffusers ones (OIHW conv weights, (out, in) linear weights), so a
diffusers state dict loads directly. Every 3x3 stride-1 convolution runs
through the conv kernel (`ops/conv.py`); stride-2 convolutions use
F.conv2d, as the JAX package uses XLA's convolution there.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from storygen_tpu_torch.ops import route
from storygen_tpu_torch.ops.conv import Conv3x3Fn, conv3x3_plain, pack_weight


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


class TimestepEmbedding(nn.Module):
    """linear_1 -> SiLU -> linear_2."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


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


class Conv1x1(nn.Module):
    """1x1 convolution over the channel axis (diffusers Conv2d(k=1))."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 1, 1))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0, 0], self.bias)


class Conv3x3(nn.Module):
    """3x3 stride-1 SAME convolution through the conv kernel. While no
    gradient can flow to the weight (it does not require grad, or grad
    mode is off), the packed (9, Cin, Cout) weight is cached and rebuilt
    when the weight changes; otherwise it is packed at every call,
    differentiably."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self._packed = None
        self._packed_key = None

    def packed_weight(self, dtype: torch.dtype) -> torch.Tensor:
        w = self.weight
        if w.requires_grad and torch.is_grad_enabled():
            return pack_weight(w, dtype)
        key = (w.data_ptr(), w._version, w.device, dtype)
        if self._packed_key != key:
            self._packed = pack_weight(w.detach(), dtype)
            self._packed_key = key
        return self._packed

    def forward(self, x: torch.Tensor,
                extra_bias: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`extra_bias` (B, Cout) is added with the bias (the resnet temb
        term); `residual` (B, H, W, Cout) is added to the output."""
        bias = self.bias.float()
        if extra_bias is not None:
            bias = bias[None] + extra_bias.float()
        fn = route(Conv3x3Fn.apply, conv3x3_plain)
        return fn(x.contiguous(), self.packed_weight(x.dtype), bias,
                  None if residual is None else residual.contiguous())


class StridedConv(nn.Module):
    """3x3 stride-2 convolution (F.conv2d) with explicit (top, bottom,
    left, right) zero padding over NHWC."""

    def __init__(self, cin: int, cout: int, pad=(1, 1, 1, 1)):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.pad = pad

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t, bo, le, ri = self.pad
        xc = F.pad(x.permute(0, 3, 1, 2), (le, ri, t, bo))
        y = F.conv2d(xc, self.weight, self.bias, stride=2)
        return y.permute(0, 2, 3, 1).contiguous()


class ResnetBlock2D(nn.Module):
    """GN -> SiLU -> conv1 (+temb) -> GN -> SiLU -> conv2 (+ shortcut).
    With temb_channels=None it is the VAE's resnet (no time embedding)."""

    def __init__(self, cin: int, cout: int, groups: int, eps: float,
                 temb_channels: Optional[int] = None):
        super().__init__()
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
        extra = None
        if temb is not None:
            extra = self.time_emb_proj(F.silu(temb))
        h = self.conv1(self.norm1(x), extra_bias=extra)
        skip = self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x
        return self.conv2(self.norm2(h), residual=skip)


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv with padding 1 (UNet), held as `.conv`."""

    def __init__(self, channels: int, pad=(1, 1, 1, 1)):
        super().__init__()
        self.conv = StridedConv(channels, channels, pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x upsample, then a 3x3 conv (held as `.conv`)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return self.conv(x)
