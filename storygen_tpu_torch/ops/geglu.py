"""Fused GEGLU -> output GEMM: wrapper of `csrc/geglu_matmul.cu`, its
plain PyTorch version, and the differentiable `GegluMatmulFn`.

Replaces `_geglu_kernel` of storygen_tpu/ops/pallas_geglu.py (reached
through `geglu_matmul`). From the packed projection proj (M, 2N) =
[value | gate] it computes (value * gelu_erf(gate)) @ weight.T + bias, where
weight is the nn.Linear weight (E, N); the gated product never reaches
memory in the kernel. The backward is plain fp32 torch (`_bwd` of the JAX
module, which runs in XLA outside any Pallas kernel).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

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


def geglu_matmul_bwd_plain(proj: torch.Tensor, weight: torch.Tensor,
                           g: torch.Tensor, need_dproj: bool = True,
                           need_dw: bool = True, need_db: bool = True
                           ) -> Tuple[Optional[torch.Tensor], ...]:
    """(dproj, dweight, dbias) of the GEGLU GEMM for the output cotangent g
    (M, E), in fp32 from the saved proj and weight; a gradient not asked
    for is None. dproj is in proj's dtype, dweight in weight's, dbias
    fp32."""
    n = proj.shape[-1] // 2
    value, gate = proj[:, :n].float(), proj[:, n:].float()
    cdf = 0.5 * (1.0 + torch.erf(gate * 2.0 ** -0.5))
    act = gate * cdf  # gelu(gate)
    gf = g.float()
    dproj = dw = db = None
    if need_dw:
        dw = (gf.t() @ (value * act)).to(weight.dtype)
    if need_db:
        db = gf.sum(0)
    if need_dproj:
        dgated = gf @ weight.float()
        pdf = torch.exp(-0.5 * gate * gate) / math.sqrt(2.0 * math.pi)
        dproj = torch.cat([dgated * act, dgated * value * (cdf + gate * pdf)],
                          dim=1).to(proj.dtype)
    return dproj, dw, db


class GegluMatmulFn(torch.autograd.Function):
    """Forward kernel G (`geglu_matmul`); plain fp32 backward that skips
    the weight and bias gradients when they are not needed."""

    @staticmethod
    def forward(ctx, proj, weight, bias):
        out = geglu_matmul(proj, weight, bias)
        ctx.save_for_backward(proj, weight)
        ctx.bias_dtype = bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        proj, weight = ctx.saved_tensors
        dproj, dw, db = geglu_matmul_bwd_plain(proj, weight, g,
                                               *ctx.needs_input_grad)
        return dproj, dw, None if db is None else db.to(ctx.bias_dtype)
