"""CLIP's vision tower and the two-tower CLIPModel as plain nn.Modules,
for the evaluation scorers (evaluation/clip_scores.py).

Counterpart of transformers' CLIPVisionTransformer and CLIPModel, which
the JAX package's scorers run (storygen_tpu/evaluation/clip_scores.py):
a patch conv without bias, a class token, learned positions over the
patches and the class token, `pre_layrnorm` (transformers' spelling, so
the keys load unchanged), the pre-LN encoder layers of the text tower,
`post_layernorm` on the class token, and the bias-free projections with
`logit_scale`. The vision self-attention is unmasked, which
clip_text.CLIPAttention computes with the plain fp32-softmax attention
(transformers' eager path): the scorers run in fp32 at head dims the
flash kernel does not take, so it stays off kernel F. The patch conv is
F.conv2d (cuDNN on the card, with PyTorch's TF32 default).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from storygen_tpu_torch.configs import CLIPConfig, CLIPVisionConfig
from storygen_tpu_torch.models.attention import LayerNorm
from storygen_tpu_torch.models.clip_text import CLIPEncoder, CLIPTextTransformer


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, d,
                                         cfg.patch_size, cfg.patch_size,
                                         bias=False)
        self.position_embedding = nn.Embedding(cfg.num_patches + 1, d)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        w = self.patch_embedding.weight
        patches = self.patch_embedding(pixel_values.to(w.dtype))
        patches = patches.flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(patches.shape[0], 1, -1)
        x = torch.cat([cls, patches], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)[None]
        return x + self.position_embedding(positions)


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values (B, C, H, W) -> the pooled class token (B,
        hidden)."""
        x = self.pre_layrnorm(self.embeddings(pixel_values))
        for layer in self.encoder.layers:
            x = layer(x)
        return self.post_layernorm(x[:, 0])


class CLIPModel(nn.Module):
    def __init__(self, config: CLIPConfig = CLIPConfig()):
        super().__init__()
        self.config = config
        t, v = config.text_config, config.vision_config
        self.text_model = CLIPTextTransformer(t)
        self.vision_model = CLIPVisionTransformer(v)
        self.visual_projection = nn.Linear(v.hidden_size,
                                           config.projection_dim, bias=False)
        self.text_projection = nn.Linear(t.hidden_size,
                                         config.projection_dim, bias=False)
        self.logit_scale = nn.Parameter(
            torch.tensor(float(config.logit_scale_init_value)))

    def get_image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) preprocessed pixels -> (B, projection_dim)."""
        return self.visual_projection(self.vision_model(pixel_values))

    def get_text_features(self, input_ids: torch.Tensor,
                          attention_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """(B, S) ids (and their mask) -> (B, projection_dim)."""
        hidden = self.text_model(input_ids, attention_mask)
        return self.text_projection(self.text_model.pooled(hidden, input_ids))
