"""AutoencoderKL over NHWC: encoder, decoder and the diagonal Gaussian.

Counterpart of storygen_tpu/models/vae.py. The encoder's downsample convs
pad (0, 1) bottom/right before a stride-2 valid conv, as diffusers does; the
decoder's upsample is nearest 2x then a 3x3 conv. The mid block's
single-head attention stays plain (an einsum chain in the JAX package).
`conv` (configs.ConvKernels) picks the kernels of every resnet and of the
encoder's downsamplers. Sharded by parallel/tensor.py, the mid block's
attention holds the rank's query / key / value channels and proj_attn
columns: its fp32 logits are all-reduced before the softmax.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from storygen_tpu_torch.configs import ConvKernels, VAEConfig
from storygen_tpu_torch.models.layers import (Conv1x1, Conv3x3, Downsample2D,
                                              GroupNorm, ResnetBlock2D,
                                              Upsample2D)


class VAEAttentionBlock(nn.Module):
    """Single-head self-attention over spatial tokens (diffusers 0.13
    AttentionBlock names: group_norm, query, key, value, proj_attn)."""

    tp = None  # the tensor group when sharded (parallel/tensor.py)

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, ch, eps=1e-6)
        self.query = nn.Linear(ch, ch)
        self.key = nn.Linear(ch, ch)
        self.value = nn.Linear(ch, ch)
        self.proj_attn = nn.Linear(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape  # c is the full channel count, sharded or not
        y = self.group_norm(x).reshape(b, h * w, c)
        if self.tp is not None:
            y = self.tp.copy_in(y)
        q, k, v = self.query(y), self.key(y), self.value(y)
        logits = torch.matmul(q.float(), k.float().transpose(1, 2))
        if self.tp is not None:
            logits = self.tp.reduce(logits)
        probs = torch.softmax(logits * c ** -0.5, dim=-1).to(x.dtype)
        y = torch.matmul(probs.float(), v.float()).to(x.dtype)
        if self.tp is None:
            return self.proj_attn(y).reshape(b, h, w, c) + x
        lin = self.proj_attn
        return self.tp.reduce_out(
            torch.nn.functional.linear(y.float(), lin.weight.float()),
            lin.bias, x.dtype, x.reshape(b, h * w, c)).reshape(b, h, w, c)


class VAEMidBlock(nn.Module):
    def __init__(self, ch: int, groups: int, conv: ConvKernels):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(ch, ch, groups, 1e-6,
                          fused_prologue=conv.fused_prologue)
            for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttentionBlock(ch, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class DownEncoderBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, groups: int,
                 add_downsample: bool, conv: ConvKernels):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(cin if i == 0 else cout, cout, groups, 1e-6,
                          fused_prologue=conv.fused_prologue)
            for i in range(layers)])
        if add_downsample:
            self.downsamplers = nn.ModuleList([
                Downsample2D(cout, pad=(0, 1, 0, 1), strided=conv.strided)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
        return x


class UpDecoderBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, groups: int,
                 add_upsample: bool, conv: ConvKernels):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(cin if i == 0 else cout, cout, groups, 1e-6,
                          fused_prologue=conv.fused_prologue)
            for i in range(layers)])
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(cout)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, conv: ConvKernels):
        super().__init__()
        ch, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = Conv3x3(cfg.in_channels, ch[0])
        self.down_blocks = nn.ModuleList([
            DownEncoderBlock2D(ch[0] if i == 0 else ch[i - 1], c,
                               cfg.layers_per_block, g, i != len(ch) - 1,
                               conv)
            for i, c in enumerate(ch)])
        self.mid_block = VAEMidBlock(ch[-1], g, conv)
        self.conv_norm_out = GroupNorm(g, ch[-1], 1e-6, act="silu")
        self.conv_out = Conv3x3(ch[-1], 2 * cfg.latent_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, conv: ConvKernels):
        super().__init__()
        rev, g = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = Conv3x3(cfg.latent_channels, rev[0])
        self.mid_block = VAEMidBlock(rev[0], g, conv)
        self.up_blocks = nn.ModuleList([
            UpDecoderBlock2D(rev[0] if i == 0 else rev[i - 1], c,
                             cfg.layers_per_block + 1, g, i != len(rev) - 1,
                             conv)
            for i, c in enumerate(rev)])
        self.conv_norm_out = GroupNorm(g, rev[-1], 1e-6, act="silu")
        self.conv_out = Conv3x3(rev[-1], cfg.out_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(self.conv_norm_out(x))


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        """mean + std * noise, with noise ~ N(0, 1) of the mean's shape."""
        return self.mean + torch.exp(0.5 * self.logvar) * noise


class AutoencoderKL(nn.Module):
    """encode: (B, H, W, 3) -> DiagonalGaussian over (B, H/8, W/8, 4) in
    fp32; decode: latents -> image. The 0.18215 scaling is the caller's."""

    def __init__(self, config: VAEConfig = VAEConfig(),
                 conv: ConvKernels = ConvKernels()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config, conv)
        self.decoder = Decoder(config, conv)
        self.quant_conv = Conv1x1(2 * config.latent_channels,
                                  2 * config.latent_channels)
        self.post_quant_conv = Conv1x1(config.latent_channels,
                                       config.latent_channels)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        moments = self.quant_conv(self.encoder(x.to(self.dtype))).float()
        mean, logvar = moments.chunk(2, dim=-1)
        return DiagonalGaussian(mean, logvar.clamp(-30.0, 20.0))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.to(self.dtype)))
