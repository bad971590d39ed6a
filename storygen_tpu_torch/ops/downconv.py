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

Kernel D runs kernel C's wgmma template (`csrc/conv_wgmma.cuh`) at stride
2, in the instantiations listed in `DOWN_BUILT`, picked by `down_tile`;
anything else raises ValueError. It takes C's split of the 9 Cin
reduction at the few-pixel sites (`conv.split_count`, a function of the
output's shape without the batch). TMA lands the even and the odd input
columns as two planes (`plane_taps` spells out where each tap reads).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from storygen_tpu_torch.ops import _build
from storygen_tpu_torch.ops.conv import (check_kernel_operands, pick_tile,
                                         split_count, tile_key,
                                         workspace_shape)

# The instantiations of kernel D in csrc/downconv3x3.cu (its SG_BUILT
# lines), keyed and valued as ops/conv.py's CONV_BUILT (family WGMMA, then
# TH, TW, images a block, consumer warpgroups, 64-row tiles a warpgroup,
# BN, CK, ring stages): the W class is that of the output width.
DOWN_BUILT = {
    (2, 0, 0, 1, 2): (1, 8, 32, 1, 4, 1, 128, 16, 3),
    (2, 0, 0, 2, 2): (1, 4, 32, 1, 2, 1, 160, 16, 3),
    (2, 0, 0, 1, 1): (1, 8, 16, 1, 2, 1, 128, 16, 4),
    (2, 0, 0, 2, 1): (1, 8, 16, 1, 2, 1, 160, 16, 3),
    (2, 0, 0, 1, 0): (1, 8, 8, 3, 3, 1, 64, 32, 2),
    (2, 0, 0, 2, 0): (1, 8, 8, 3, 3, 1, 160, 16, 3),
}


def down_tile(cin: int, cout: int, wo: int) -> tuple:
    """The line that kernel D runs for an output `wo` columns wide (a
    DOWN_BUILT value). ValueError if none is built."""
    return pick_tile(DOWN_BUILT, tile_key(2, False, cin, cout, wo))


def down_splits(cin: int, cout: int, ho: int, wo: int) -> int:
    """`conv.split_count` of D's line at an (ho, wo) output: the runs its 9
    Cin reduction is split into, whatever the batch."""
    return split_count(down_tile(cin, cout, wo), cin, cout, ho, wo)


def plane_taps(wo: int, pl: int):
    """Where kernel D's slab finds each input column, as a pure function of
    the output width and the left padding: for output column ox and tap
    dx, (plane, half-column) with the input column 2 ox + dx - pl =
    2 * half-column + plane. The slab holds both planes from half-column
    -ceil(pl / 2) on, and tap dx reads plane (dx + pl % 2) % 2 at
    half-column offset (dx + pl % 2) // 2 past ox (csrc/conv_wgmma.cuh's
    tap_row)."""
    first = -((pl + 1) // 2)
    out = {}
    for ox in range(wo):
        for dx in range(3):
            u = dx + pl % 2
            out[ox, dx] = (u % 2, first + ox + u // 2)
    return out


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


def _launch(x, w9, bias, pad, lib=None, line=None) -> torch.Tensor:
    """One launch of sg_downconv3x3 from `lib` (the built library if None;
    the tile study passes one built with another SG_BUILT line, and that
    line as `line`), with the split reduction's workspace where the line
    splits it. A Cout that 8 does not divide runs on weights and bias
    padded with zero columns (TMA reads whole 16-byte weight rows), and a
    one-column input on a zero second column (the odd plane needs one):
    both give the same output."""
    check_kernel_operands(x, w9)
    b, h, w, cin = x.shape
    cout = w9.shape[2]
    ho, wo = out_size(h, w, pad)
    c8 = -(-cout // 8) * 8
    if line is None:
        line = down_tile(cin, c8, wo)
    bias32 = bias.float()
    if c8 != cout:
        w9 = F.pad(w9, (0, c8 - cout)).contiguous()
        bias32 = F.pad(bias32, (0, c8 - cout))
    if w == 1:
        x = F.pad(x, (0, 0, 0, 1)).contiguous()
    bias32 = bias32.contiguous()
    shape = workspace_shape(False, b, ho, wo, cin, c8, line)
    out = torch.empty((b, ho, wo, c8), dtype=x.dtype, device=x.device)
    ws = None if shape is None else torch.empty(
        shape, dtype=torch.float32, device=x.device)
    err = (lib or _build.load()).sg_downconv3x3(
        x.data_ptr(), w9.data_ptr(), bias32.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        1 if shape is None else shape[0], b, x.shape[1], x.shape[2], cin,
        c8, ho, wo, int(pad[0]), int(pad[2]),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "sg_downconv3x3")
    return out if c8 == cout else out[..., :cout].contiguous()


def downconv3x3(x: torch.Tensor, w9: torch.Tensor, bias: torch.Tensor,
                pad: Sequence[int]) -> torch.Tensor:
    """x (B, H, W, Cin), w9 (9, Cin, Cout), bias (Cout), pad (top, bottom,
    left, right) -> (B, Ho, Wo, Cout). Launches kernel D for CUDA tensors
    and runs the plain version for CPU tensors."""
    _check(x, w9, bias, pad)
    if x.device.type == "cpu":
        return downconv3x3_plain(x, w9, bias, pad)
    out = _launch(x, w9, bias, pad)
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
