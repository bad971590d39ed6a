"""Multi-head attention over projected (B, S, H*D) tensors.

Counterpart of storygen_tpu/ops/attention.py. Unmasked attention (every
UNet CrossAttention: attn1, attn2 and attn3) and attention under a
per-reference `ref_mask` (attn3 in stage-2 training) go to the flash
kernels (`ops/flash_attention.py`); an elementwise mask (CLIP's causal
mask) stays on the plain path, as it stays on XLA in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from storygen_tpu_torch.ops import route
from storygen_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_attention, flash_attention_plain, merge_heads, plain_attention,
    split_heads)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int,
                         mask: Optional[torch.Tensor] = None,
                         ref_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """q (B, Sq, H*D), k/v (B, Skv, H*D) -> (B, Sq, H*D).

    mask: broadcastable boolean (B, 1|H, Sq, Skv), True = keep.
    ref_mask: (B, N) keep flags over the N equal reference spans of the kv
      (attn3's kv-concat layout); on the plain path it is expanded to an
      elementwise kv mask, as storygen_tpu/ops/attention.py does.
    """
    scale = (q.shape[-1] // num_heads) ** -0.5
    if mask is not None:
        if ref_mask is not None:
            raise ValueError("give mask or ref_mask, not both")
        out = plain_attention(split_heads(q, num_heads),
                              split_heads(k, num_heads),
                              split_heads(v, num_heads), scale, mask)
        return merge_heads(out)
    fn = route(flash_attention, flash_attention_plain)
    return fn(q, k, v, num_heads, scale, ref_mask)
