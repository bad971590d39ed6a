"""3x3 stride-2 convolution over NHWC with explicit zero padding: wrapper of
`csrc/downconv3x3.cu` (kernel D), its plain PyTorch version, and the
differentiable `DownConv3x3Fn`.

Replaces `_down_kernel` of storygen_tpu/ops/pallas_conv.py (reached through
`halo_downconv` / `downconv3x3`): fp32 accumulation and a (Cout) bias.
`pad` is (top, bottom, left, right): (1, 1, 1, 1) at the UNet's
Downsample2D, (0, 1, 0, 1) at the VAE encoder's. Weights come packed as
(9, Cin, Cout), tap-major (3*dy + dx), as for the stride-1 conv. The
backward is plain fp32 torch, as `_downconv3x3_bwd` of the JAX module is
plain XLA: per tap, one product with the strided input slice.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from storygen_tpu_torch.ops import _build
from storygen_tpu_torch.ops.conv import check_kernel_operands


def out_size(h: int, w: int, pad: Sequence[int]) -> Tuple[int, int]:
    t, bo, le, ri = pad
    return (h + t + bo - 3) // 2 + 1, (w + le + ri - 3) // 2 + 1


def downconv3x3_plain(x: torch.Tensor, w9: torch.Tensor, bias: torch.Tensor,
                      pad: Sequence[int]) -> torch.Tensor:
    """fp32 convolution and bias; result in x's dtype."""
    t, bo, le, ri = pad
    cin, cout = w9.shape[1:]
    w = w9.float().reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
    xp = F.pad(x.float().permute(0, 3, 1, 2), (le, ri, t, bo))
    y = F.conv2d(xp, w, bias.float(), stride=2)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _check(x, w9, bias, pad):
    if x.dim() != 4 or w9.dim() != 3 or w9.shape[0] != 9:
        raise ValueError("x must be (B, H, W, Cin) and w9 (9, Cin, Cout)")
    if w9.shape[1] != x.shape[3]:
        raise ValueError(f"w9 has Cin {w9.shape[1]}, x has {x.shape[3]}")
    if tuple(bias.shape) != (w9.shape[2],):
        raise ValueError(f"bias must be ({w9.shape[2]},), got "
                         f"{tuple(bias.shape)}")
    if len(pad) != 4 or any(int(p) != p or p < 0 for p in pad):
        raise ValueError(f"pad must be 4 non-negative ints, got {pad}")
    if min(out_size(x.shape[1], x.shape[2], pad)) < 1:
        raise ValueError(f"no output for {tuple(x.shape)} with pad {pad}")
    if len({x.device, w9.device, bias.device}) != 1:
        raise ValueError("all operands must be on one device")


def downconv3x3(x: torch.Tensor, w9: torch.Tensor, bias: torch.Tensor,
                pad: Sequence[int]) -> torch.Tensor:
    """x (B, H, W, Cin), w9 (9, Cin, Cout), bias (Cout), pad (top, bottom,
    left, right) -> (B, Ho, Wo, Cout). Launches kernel D for CUDA tensors
    and runs the plain version for CPU tensors."""
    _check(x, w9, bias, pad)
    if x.device.type == "cpu":
        return downconv3x3_plain(x, w9, bias, pad)
    check_kernel_operands(x, w9)
    b, h, w, cin = x.shape
    cout = w9.shape[2]
    ho, wo = out_size(h, w, pad)
    bias32 = bias.float().contiguous()
    out = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    lib = _build.load()
    err = lib.sg_downconv3x3(
        x.data_ptr(), w9.data_ptr(), bias32.data_ptr(), out.data_ptr(),
        b, h, w, cin, cout, ho, wo, int(pad[0]), int(pad[2]),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "sg_downconv3x3")
    downconv3x3.launches += 1
    return out


downconv3x3.launches = 0


def _taps(ho: int, wo: int):
    """(tap, rows, cols) of each tap: the strided slices of the padded
    input that it reads for an (ho, wo) output."""
    for dy in range(3):
        for dx in range(3):
            yield (3 * dy + dx, slice(dy, dy + 2 * ho - 1, 2),
                   slice(dx, dx + 2 * wo - 1, 2))


def downconv3x3_dinput_plain(g: torch.Tensor, w9: torch.Tensor, x_shape,
                             pad: Sequence[int]) -> torch.Tensor:
    """fp32 input gradient: each tap's g @ w9[tap]^T added into the
    stride-2 positions of the padded input it read, then the padding cut
    away."""
    b, h, w, cin = x_shape
    t, bo, le, ri = pad
    ho, wo = g.shape[1:3]
    gf = g.float().reshape(b * ho * wo, -1)
    dxp = torch.zeros((b, h + t + bo, w + le + ri, cin), dtype=torch.float32,
                      device=g.device)
    for tap, rows, cols in _taps(ho, wo):
        dxp[:, rows, cols, :] += (gf @ w9[tap].float().t()).reshape(
            b, ho, wo, cin)
    return dxp[:, t:t + h, le:le + w, :]


def downconv3x3_dweight_plain(x: torch.Tensor, g: torch.Tensor,
                              pad: Sequence[int]) -> torch.Tensor:
    """(9, Cin, Cout) fp32 weight gradient: per tap, the strided input
    slice contracted with g over (B, Ho, Wo)."""
    b, h, w, cin = x.shape
    t, bo, le, ri = pad
    ho, wo = g.shape[1:3]
    xp = F.pad(x.float(), (0, 0, le, ri, t, bo))
    gf = g.float().reshape(b * ho * wo, -1)
    return torch.stack([
        xp[:, rows, cols, :].reshape(b * ho * wo, cin).t() @ gf
        for _, rows, cols in _taps(ho, wo)])


class DownConv3x3Fn(torch.autograd.Function):
    """Forward kernel D (`downconv3x3`); backward plain fp32 (dx, dw, dbias),
    each computed only when needed."""

    @staticmethod
    def forward(ctx, x, w9, bias, pad):
        out = downconv3x3(x, w9, bias, pad)
        ctx.save_for_backward(x, w9)
        ctx.pad, ctx.bias_dtype = tuple(pad), bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, w9 = ctx.saved_tensors
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        dx = dw = db = None
        if need_x:
            dx = downconv3x3_dinput_plain(g, w9, x.shape, ctx.pad).to(x.dtype)
        if need_w:
            dw = downconv3x3_dweight_plain(x, g, ctx.pad).to(w9.dtype)
        if need_b:
            db = g.float().sum((0, 1, 2)).to(ctx.bias_dtype)
        return dx, dw, db, None
