"""StoryGen conditional UNet: SD-1.5 UNet plus the VLCM image context.

Counterpart of storygen_tpu/models/unet.py and unet_blocks.py. One forward
serves both cycles: with `image_context=None` it collects the 16 post-attn1
taps (the reference cycle), with a dict it feeds each block's entry to attn3
(the image cycle), under an optional per-reference `ref_mask`. Keys derive
from the block index: down_{1..3}_{1,2}, mid, up_{1..3}_{1..3}. With
`gradient_checkpointing` each down, mid and up block runs under
torch.utils.checkpoint when grad is enabled (the JAX `remat`). `conv`
(configs.ConvKernels) picks the kernels of every resnet and downsampler.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from storygen_tpu_torch.configs import ConvKernels, UNetConfig
from storygen_tpu_torch.models.attention import Transformer2DModel
from storygen_tpu_torch.models.layers import (Conv3x3, Downsample2D,
                                              GroupNorm, ResnetBlock2D,
                                              TimestepEmbedding, Upsample2D,
                                              get_timestep_embedding)

Context = Dict[str, torch.Tensor]

CONTEXT_KEYS = tuple(
    [f"down_{i}_{j}" for i in (1, 2, 3) for j in (1, 2)] + ["mid"]
    + [f"up_{i}_{j}" for i in (1, 2, 3) for j in (1, 2, 3)])


def down_block_key(block_idx: int, layer_idx: int) -> str:
    return f"down_{block_idx + 1}_{layer_idx + 1}"


def up_block_key(block_idx: int, layer_idx: int) -> str:
    return f"up_{block_idx}_{layer_idx + 1}"


class DownBlock(nn.Module):
    """[Resnet (-> Transformer2D)] x layers (-> Downsample): both
    CrossAttnDownBlock2D and DownBlock2D."""

    def __init__(self, cfg: UNetConfig, idx: int, cin: int, cout: int,
                 cross: bool, add_downsample: bool, conv: ConvKernels):
        super().__init__()
        self.idx = idx
        temb = cfg.time_embed_dim
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        self.resnets = nn.ModuleList([
            ResnetBlock2D(cin if i == 0 else cout, cout, g, eps, temb,
                          conv.fused_prologue)
            for i in range(cfg.layers_per_block)])
        if cross:
            self.attentions = nn.ModuleList([
                Transformer2DModel(cfg.num_heads, cout // cfg.num_heads, cout,
                                   cfg.cross_attention_dim, g)
                for _ in range(cfg.layers_per_block)])
        if add_downsample:
            self.downsamplers = nn.ModuleList([
                Downsample2D(cout, strided=conv.strided)])

    def forward(self, h, temb, text, ctx: Optional[Context],
                ref_mask: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, List, Context]:
        states, taps = [], {}
        for i, resnet in enumerate(self.resnets):
            h = resnet(h, temb)
            if hasattr(self, "attentions"):
                key = down_block_key(self.idx, i)
                h, tap = self.attentions[i](
                    h, text, None if ctx is None else ctx[key], ref_mask)
                if ctx is None:
                    taps[key] = tap
            states.append(h)
        if hasattr(self, "downsamplers"):
            h = self.downsamplers[0](h)
            states.append(h)
        return h, states, taps


class MidBlock(nn.Module):
    """Resnet -> Transformer2D -> Resnet (UNetMidBlock2DCrossAttn)."""

    def __init__(self, cfg: UNetConfig, ch: int, conv: ConvKernels):
        super().__init__()
        temb = cfg.time_embed_dim
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        self.resnets = nn.ModuleList([
            ResnetBlock2D(ch, ch, g, eps, temb, conv.fused_prologue)
            for _ in range(2)])
        self.attentions = nn.ModuleList([Transformer2DModel(
            cfg.num_heads, ch // cfg.num_heads, ch, cfg.cross_attention_dim,
            g)])

    def forward(self, h, temb, text, ctx: Optional[Context],
                ref_mask: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, Context]:
        h = self.resnets[0](h, temb)
        h, tap = self.attentions[0](h, text, None if ctx is None
                                    else ctx["mid"], ref_mask)
        return self.resnets[1](h, temb), {"mid": tap} if ctx is None else {}


class UpBlock(nn.Module):
    """[concat skip -> Resnet (-> Transformer2D)] x layers (-> Upsample):
    both CrossAttnUpBlock2D and UpBlock2D."""

    def __init__(self, cfg: UNetConfig, idx: int, prev_ch: int, cout: int,
                 skip_chs: List[int], cross: bool, add_upsample: bool,
                 conv: ConvKernels):
        super().__init__()
        self.idx = idx
        temb = cfg.time_embed_dim
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        self.resnets = nn.ModuleList([
            ResnetBlock2D((prev_ch if i == 0 else cout) + skip_chs[i], cout,
                          g, eps, temb, conv.fused_prologue)
            for i in range(len(skip_chs))])
        if cross:
            self.attentions = nn.ModuleList([
                Transformer2DModel(cfg.num_heads, cout // cfg.num_heads, cout,
                                   cfg.cross_attention_dim, g)
                for _ in skip_chs])
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(cout)])

    def forward(self, h, skips: List[torch.Tensor], temb, text,
                ctx: Optional[Context], ref_mask: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, Context]:
        taps = {}
        for i, resnet in enumerate(self.resnets):
            h = resnet(torch.cat([h, skips[-(i + 1)]], dim=-1), temb)
            if hasattr(self, "attentions"):
                key = up_block_key(self.idx, i)
                h, tap = self.attentions[i](
                    h, text, None if ctx is None else ctx[key], ref_mask)
                if ctx is None:
                    taps[key] = tap
        if hasattr(self, "upsamplers"):
            h = self.upsamplers[0](h)
        return h, taps


class UNet2DConditionModel(nn.Module):
    # the dtype the UNet computes in; None: its parameters' (conv_in's).
    # A trainer that keeps the trained parameters in fp32 while the model
    # computes in bf16, as the JAX package's module dtype does, sets it
    # when every parameter trains (the "full" subset)
    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, config: UNetConfig = UNetConfig(),
                 conv: ConvKernels = ConvKernels()):
        super().__init__()
        cfg = self.config = config
        if cfg.mid_block_type != "UNetMidBlock2DCrossAttn":
            raise ValueError(f"unsupported mid block {cfg.mid_block_type}")
        if (cfg.conv_in_kernel, cfg.conv_out_kernel) != (3, 3):
            raise ValueError("conv_in/conv_out must be 3x3")
        ch = cfg.block_out_channels
        self.time_embedding = TimestepEmbedding(ch[0], cfg.time_embed_dim)
        self.conv_in = Conv3x3(cfg.in_channels, ch[0])
        n = len(ch)
        self.down_blocks = nn.ModuleList()
        skip_chs = [ch[0]]
        for i, kind in enumerate(cfg.down_block_types):
            if kind not in ("CrossAttnDownBlock2D", "DownBlock2D"):
                raise ValueError(kind)
            cin = ch[0] if i == 0 else ch[i - 1]
            last = i == n - 1
            self.down_blocks.append(DownBlock(
                cfg, i, cin, ch[i], kind == "CrossAttnDownBlock2D",
                not last, conv))
            skip_chs += [ch[i]] * (cfg.layers_per_block + (0 if last else 1))
        self.mid_block = MidBlock(cfg, ch[-1], conv)
        self.up_blocks = nn.ModuleList()
        rev = list(reversed(ch))
        prev = ch[-1]
        n_layers = cfg.layers_per_block + 1
        for i, kind in enumerate(cfg.up_block_types):
            if kind not in ("CrossAttnUpBlock2D", "UpBlock2D"):
                raise ValueError(kind)
            skips = skip_chs[-n_layers:]
            skip_chs = skip_chs[:-n_layers]
            # consumed last-first: resnet i takes skips[-(i + 1)]
            self.up_blocks.append(UpBlock(
                cfg, i, prev, rev[i], list(reversed(skips)),
                kind == "CrossAttnUpBlock2D", i != n - 1, conv))
            prev = rev[i]
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch[0],
                                       cfg.norm_eps, act="silu")
        self.conv_out = Conv3x3(ch[0], cfg.out_channels)
        self.gradient_checkpointing = False

    def _block(self, blk: nn.Module, *args):
        if self.gradient_checkpointing and torch.is_grad_enabled():
            return checkpoint(blk, *args, use_reentrant=False)
        return blk(*args)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                image_context: Optional[Context] = None,
                ref_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Context]:
        """sample (B, H, W, 4) NHWC, timesteps () or (B,), text (B, 77, D),
        image_context None (collect) or {key: (B, S*n_refs, C)} (consume),
        ref_mask None or (B, n_refs) bool: the reference frames attn3 may
        attend to (used only with an image context).
        Returns (eps (B, H, W, 4), collected context)."""
        cfg = self.config
        dtype = self.compute_dtype or self.conv_in.weight.dtype
        b = sample.shape[0]
        ts = torch.as_tensor(timesteps, device=sample.device)
        if ts.dim() == 0:
            ts = ts.expand(b)
        t_emb = get_timestep_embedding(ts, cfg.block_out_channels[0],
                                       cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(t_emb.to(dtype))
        text = encoder_hidden_states.to(dtype)
        if image_context is None:
            ref_mask = None
        h = self.conv_in(sample.to(dtype))
        collected: Context = {}
        states = [h]
        for blk in self.down_blocks:
            h, st, taps = self._block(blk, h, temb, text, image_context,
                                      ref_mask)
            states += st
            collected.update(taps)
        h, taps = self._block(self.mid_block, h, temb, text, image_context,
                              ref_mask)
        collected.update(taps)
        n_layers = cfg.layers_per_block + 1
        for blk in self.up_blocks:
            skips, states = states[-n_layers:], states[:-n_layers]
            h, taps = self._block(blk, h, skips, temb, text, image_context,
                                  ref_mask)
            collected.update(taps)
        h = self.conv_out(self.conv_norm_out(h))
        return h, collected
