"""CLIP text encoder as a plain nn.Module (token ids in, last_hidden_state
out; `pooled` gives the row that transformers' text features project).

Counterpart of storygen_tpu/models/clip_text.py: pre-LN layers, causal
self-attention (masked, so on the plain attention path), final LayerNorm.
The activation is the config's `hidden_act`: quick_gelu (SD-1.5's ViT-L/14
text encoder, which the JAX package hard-codes) or gelu (erf GELU, as
transformers' CLIP computes it for a config that names it, e.g. the CLIP-H
tower of PickScore_v1). Parameter names follow transformers' CLIPTextModel
(`text_model.embeddings...`, `text_model.encoder.layers.{i}...`).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from storygen_tpu_torch.configs import CLIPTextConfig
from storygen_tpu_torch.models.attention import LayerNorm
from storygen_tpu_torch.ops.attention import multi_head_attention
from storygen_tpu_torch.ops.flash_attention import flash_attention_plain


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


# hidden_act -> the function (transformers' ACT2FN of the same names)
ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": F.gelu}


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name not in ACTIVATIONS:
        raise ValueError(f"hidden_act {name!r}: one of {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Masked (the text tower's causal mask) through the plain masked
        path; unmasked (the vision tower) in fp32 softmax off kernel F,
        which takes neither fp32 nor every head dim."""
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        if mask is None:
            scale = (x.shape[-1] // self.heads) ** -0.5
            out = flash_attention_plain(q, k, v, self.heads, scale)
        else:
            out = multi_head_attention(q, k, v, self.heads, mask=mask)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.act = activation(cfg.hidden_act)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    """One pre-LN layer."""

    def __init__(self, cfg):
        super().__init__()
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)


class CLIPEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                     for _ in range(cfg.num_hidden_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """input_ids (B, S), attention_mask (B, S) with 0 at padding ->
        last_hidden_state (B, S, hidden)."""
        s = input_ids.shape[1]
        positions = torch.arange(s, device=input_ids.device)[None]
        x = (self.embeddings.token_embedding(input_ids)
             + self.embeddings.position_embedding(positions))
        mask = torch.ones((s, s), dtype=torch.bool,
                          device=input_ids.device).tril()[None, None]
        if attention_mask is not None:
            mask = mask & attention_mask.bool()[:, None, None, :]
        for layer in self.encoder.layers:
            x = layer(x, mask)
        return self.final_layer_norm(x)

    def pooled(self, hidden: torch.Tensor,
               input_ids: torch.Tensor) -> torch.Tensor:
        """The row of each sequence that CLIP's text features project
        (transformers' CLIPTextTransformer): the first eos_token_id, or for
        a legacy config whose eos_token_id is 2 the largest id."""
        eos = self.config.eos_token_id
        ids = input_ids.to(torch.int)
        at = (ids.argmax(-1) if eos == 2
              else (ids == eos).int().argmax(-1))
        return hidden[torch.arange(hidden.shape[0], device=hidden.device),
                      at]


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids (B, S) -> last_hidden_state (B, S, hidden)."""
        return self.text_model(input_ids)
