"""Flash-attention forward: wrapper of `csrc/flash_fwd.cu` and its plain
PyTorch version.

Replaces the forward kernels of storygen_tpu/ops/pallas_attention.py
(`_bnd2_kernel`, `_bnd_kernel`, `_online_t_kernel`, `_flash_kernel`, all
reached through `_flash_core`). Inputs are the projections' own layout:
q (B, Sq, H*D), k/v (B, Skv, H*D), each with a contiguous last dimension
(a k|v split view is taken as it is); the output is (B, Sq, H*D).
"""
from __future__ import annotations

from typing import Optional

import torch

from storygen_tpu_torch.ops import _build

# 16-padded head dims the kernel is instantiated for: the UNet's 40, 80, 160
_PADDED_D = (48, 80, 160)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, H*D) -> (B, H, S, D)."""
    b, s, hd = x.shape
    return x.reshape(b, s, num_heads, hd // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, H*D)."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over (B, H, S, D) with an fp32 softmax; `mask` is a
    broadcastable boolean (True = keep). Probabilities are cast to the
    input dtype before the value product (storygen_tpu xla_attention)."""
    dtype = q.dtype
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.matmul(probs.float(), v.float()).to(dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          num_heads: int, scale: float) -> torch.Tensor:
    """Exact softmax(q k^T * scale) v per head, fp32 softmax and fp32
    accumulation, result in q's dtype."""
    out = plain_attention(split_heads(q, num_heads),
                          split_heads(k, num_heads),
                          split_heads(v, num_heads), scale)
    return merge_heads(out)


def _check(q, k, v, num_heads):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be (B, S, H*D)")
    b, _, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != hd:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if hd % num_heads:
        raise ValueError(f"H*D={hd} is not divisible by {num_heads} heads")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share a dtype")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, scale: float) -> torch.Tensor:
    """Fused attention; launches the CUDA kernel for CUDA tensors and runs
    the plain version for CPU tensors."""
    _check(q, k, v, num_heads)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, num_heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bfloat16, got {q.dtype}")
    b, sq, hd = q.shape
    skv = k.shape[1]
    d = hd // num_heads
    if d % 8 or (d + 15) // 16 * 16 not in _PADDED_D:
        raise ValueError(f"unsupported head dim {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.stride(2) != 1 or t.stride(1) % 8 or t.stride(0) % 8
                or t.data_ptr() % 16):
            raise ValueError(f"{name} needs a contiguous last dim and "
                             "16-byte aligned rows")
    out = torch.empty((b, sq, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or skv == 0:
        raise ValueError("empty attention")
    lib = _build.load()
    err = lib.sg_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, num_heads, sq, skv, d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "sg_flash_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
