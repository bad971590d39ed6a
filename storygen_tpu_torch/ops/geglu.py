"""Fused GEGLU -> output GEMM: wrapper of `csrc/geglu_matmul.cu` and its
plain PyTorch version.

Replaces `_geglu_kernel` of storygen_tpu/ops/pallas_geglu.py (reached
through `geglu_matmul`). From the packed projection proj (M, 2N) =
[value | gate] it computes (value * gelu_erf(gate)) @ weight.T + bias, where
weight is the nn.Linear weight (E, N); the gated product never reaches
memory in the kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from storygen_tpu_torch.ops import _build


def geglu_matmul_plain(proj: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """fp32 gate, the gated product rounded to proj's dtype (as the kernel
    rounds its A operand), fp32 GEMM and bias, result in proj's dtype."""
    n = proj.shape[-1] // 2
    value, gate = proj[..., :n].float(), proj[..., n:].float()
    gated = (value * F.gelu(gate)).to(proj.dtype).float()
    out = gated @ weight.float().t() + bias.float()
    return out.to(proj.dtype)


def geglu_matmul(proj: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """proj (M, 2N), weight (E, N), bias (E) -> (M, E). Launches the CUDA
    kernel for CUDA tensors and runs the plain version for CPU tensors."""
    if proj.dim() != 2 or weight.dim() != 2 or bias.dim() != 1:
        raise ValueError("proj must be (M, 2N), weight (E, N), bias (E)")
    m, n2 = proj.shape
    e, n = weight.shape
    if n2 != 2 * n or bias.shape[0] != e:
        raise ValueError(f"shape mismatch proj {tuple(proj.shape)} weight "
                         f"{tuple(weight.shape)} bias {tuple(bias.shape)}")
    if not (proj.device == weight.device == bias.device):
        raise ValueError("proj, weight, bias must be on one device")
    if proj.device.type == "cpu":
        return geglu_matmul_plain(proj, weight, bias)
    if proj.device.type != "cuda":
        raise ValueError(f"unsupported device {proj.device}")
    if proj.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise ValueError("the kernel takes bfloat16 proj and weight")
    if n % 32:
        raise ValueError(f"inner width {n} must be a multiple of 32")
    if not (proj.is_contiguous() and weight.is_contiguous()):
        raise ValueError("proj and weight must be contiguous")
    if proj.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("proj and weight must be 16-byte aligned")
    if m == 0:
        raise ValueError("empty projection")
    bias32 = bias.float().contiguous()
    out = torch.empty((m, e), dtype=proj.dtype, device=proj.device)
    lib = _build.load()
    err = lib.sg_geglu_matmul(
        proj.data_ptr(), weight.data_ptr(), bias32.data_ptr(),
        out.data_ptr(), m, n, e,
        torch.cuda.current_stream(proj.device).cuda_stream)
    _build.check(err, "sg_geglu_matmul")
    geglu_matmul.launches += 1
    return out


geglu_matmul.launches = 0
