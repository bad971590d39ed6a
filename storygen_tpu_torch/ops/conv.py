"""3x3 stride-1 SAME convolution over NHWC: wrapper of `csrc/conv3x3.cu`,
its plain PyTorch version, and the differentiable `Conv3x3Fn`.

Replaces `_kernel` (fused=False) of storygen_tpu/ops/pallas_conv.py
(reached through `halo_conv` / `conv3x3`): fp32 accumulation, a (Cout) or
per-batch (B, Cout) fp32 bias, and an optional residual added in the
epilogue. Weights come packed as (9, Cin, Cout), tap-major (3*dy + dx).
The backward follows `_conv3x3_bwd` of the JAX module: the input gradient
reuses kernel C on the spatially flipped, in/out-transposed weight; the
weight and bias gradients are plain.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from storygen_tpu_torch.ops import _build


def pack_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(Cout, Cin, 3, 3) OIHW -> (9, Cin, Cout) contiguous in `dtype`."""
    cout, cin = weight.shape[:2]
    return (weight.permute(2, 3, 1, 0).reshape(9, cin, cout)
            .to(dtype).contiguous())


def conv3x3_plain(x: torch.Tensor, w9: torch.Tensor, bias: torch.Tensor,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32 convolution, bias and residual; result in x's dtype."""
    cin, cout = w9.shape[1:]
    w = w9.float().reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w, padding=1)
    y = y.permute(0, 2, 3, 1)
    bias = bias.float()
    y = y + (bias[:, None, None, :] if bias.dim() == 2 else bias)
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def _check(x, w9, bias, residual):
    if x.dim() != 4 or w9.dim() != 3 or w9.shape[0] != 9:
        raise ValueError("x must be (B, H, W, Cin) and w9 (9, Cin, Cout)")
    b, h, w, cin = x.shape
    cout = w9.shape[2]
    if w9.shape[1] != cin:
        raise ValueError(f"w9 has Cin {w9.shape[1]}, x has {cin}")
    if tuple(bias.shape) not in ((cout,), (b, cout)):
        raise ValueError(f"bias must be ({cout},) or ({b}, {cout}), got "
                         f"{tuple(bias.shape)}")
    if residual is not None and tuple(residual.shape) != (b, h, w, cout):
        raise ValueError(f"residual must be {(b, h, w, cout)}, got "
                         f"{tuple(residual.shape)}")
    devs = {x.device, w9.device, bias.device}
    if residual is not None:
        devs.add(residual.device)
    if len(devs) != 1:
        raise ValueError("all operands must be on one device")


def conv3x3(x: torch.Tensor, w9: torch.Tensor, bias: torch.Tensor,
            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, H, W, Cin), w9 (9, Cin, Cout), bias (Cout) or (B, Cout),
    residual (B, H, W, Cout) or None -> (B, H, W, Cout). Launches the CUDA
    kernel for CUDA tensors and runs the plain version for CPU tensors."""
    _check(x, w9, bias, residual)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w9, bias, residual)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    ops = [x, w9] + ([] if residual is None else [residual])
    if any(t.dtype != torch.bfloat16 for t in ops):
        raise ValueError("the kernel takes bfloat16 x, w9 and residual")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("x, w9 and residual must be contiguous")
    if any(t.data_ptr() % 16 for t in ops):
        raise ValueError("x, w9 and residual must be 16-byte aligned")
    b, h, w, cin = x.shape
    cout = w9.shape[2]
    if x.numel() == 0 or cout == 0:
        raise ValueError("empty convolution")
    bias32 = bias.float().contiguous()
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    lib = _build.load()
    err = lib.sg_conv3x3(
        x.data_ptr(), w9.data_ptr(), bias32.data_ptr(),
        cout if bias.dim() == 2 else 0,
        None if residual is None else residual.data_ptr(),
        out.data_ptr(), b, h, w, cin, cout,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "sg_conv3x3")
    conv3x3.launches += 1
    return out


conv3x3.launches = 0


def flip_weight(w9: torch.Tensor) -> torch.Tensor:
    """(9, Cin, Cout) -> the (9, Cout, Cin) weight whose SAME convolution
    of the output cotangent is the input gradient: tap 3*dy + dx takes the
    in/out-transposed tap 3*(2-dy) + (2-dx)."""
    return w9.flip(0).transpose(1, 2).contiguous()


def conv3x3_dweight_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(9, Cin, Cout) fp32 weight gradient: per tap, the shifted input
    slice contracted with g over (B, H, W)."""
    b, h, w, cin = x.shape
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    gf = g.float().reshape(b * h * w, -1)
    return torch.stack([
        xp[:, dy:dy + h, dx:dx + w, :].reshape(b * h * w, cin).t() @ gf
        for dy in range(3) for dx in range(3)])


class Conv3x3Fn(torch.autograd.Function):
    """Forward kernel C (`conv3x3`); backward: dx by kernel C on the
    flipped weight, dw and dbias plain, the residual's gradient g. A
    gradient that is not needed is not computed."""

    @staticmethod
    def forward(ctx, x, w9, bias, residual):
        out = conv3x3(x, w9, bias, residual)
        ctx.save_for_backward(x, w9)
        ctx.bias_shape, ctx.bias_dtype = bias.shape, bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, w9 = ctx.saved_tensors
        g = g.contiguous()
        need_x, need_w, need_b, need_r = ctx.needs_input_grad
        dx = dw = db = None
        if need_x:
            zero = torch.zeros(x.shape[-1], dtype=torch.float32,
                               device=g.device)
            dx = conv3x3(g, flip_weight(w9), zero).to(x.dtype)
        if need_w:
            dw = conv3x3_dweight_plain(x, g).to(w9.dtype)
        if need_b:
            dims = (1, 2) if len(ctx.bias_shape) == 2 else (0, 1, 2)
            db = g.float().sum(dims).to(ctx.bias_dtype)
        return dx, dw, db, g if need_r else None
