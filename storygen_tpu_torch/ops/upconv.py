"""Nearest 2x upsampling followed by a 3x3 SAME convolution over NHWC, in
its phase form: the wrapper of `csrc/upconv3x3.cu` (kernel U), its plain
PyTorch version, and the differentiable `UpConv3x3Fn`.

Counterpart of `_UpsampleConv` (storygen_tpu/models/layers.py:220), which
the JAX package runs at every 2x `Upsample2D` as XLA convolutions (no
Pallas kernel). Nearest upsampling copies each source pixel 2x2, so the 3x3
conv on the upsampled grid is exactly four 2x2 convs on the source grid,
one per output phase (a, b), each tap the sum of the 3x3 taps that land on
the same source pixel: rows of phase 0 take [w0, w1 + w2], rows of phase 1
[w0 + w1, w2], and columns the same rule. 16 multiply-adds a source pixel
and channel pair instead of 36, and the (B, 2H, 2W, C) upsampled tensor
never exists. The parameters stay the 3x3 conv's (OIHW weight, bias).

Kernel U runs kernel C's wgmma template (`csrc/conv_wgmma.cuh`) in its
phase mode, in the instantiations listed in `UP_BUILT` (keyed as C's, with
the source's W class), picked by `up_tile`; anything else raises
ValueError. It takes C's split of the reduction at the few-pixel source
sites (`conv.split_count` with the four phases' blocks counted, a function
of the shape without the batch).

The backward has no kernel of its own: the input gradient is kernel C's
(the flipped 3x3 weight on the 2x grid, as `Conv3x3Fn`'s) summed over each
source pixel's 2x2 copies, the weight and bias gradients plain.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from storygen_tpu_torch.ops import _build
from storygen_tpu_torch.ops.conv import (_aligned, check_kernel_operands,
                                         conv3x3, conv3x3_dweight_plain,
                                         flip_weight, pick_tile, split_count,
                                         tile_key)

# The instantiations of kernel U in csrc/upconv3x3.cu (its SG_BUILT lines),
# keyed and valued as ops/conv.py's CONV_BUILT (family WGMMA, then TH, TW,
# images a block, consumer warpgroups, 64-row tiles a warpgroup, BN, CK,
# ring stages), with the W class of the source width: kernel C's lines at
# its stride-1 keys, each tile a tile of the source grid in one phase.
UP_BUILT = {
    (1, 0, 0, 1, 2): (1, 6, 32, 1, 3, 1, 128, 32, 2),
    (1, 0, 0, 2, 2): (1, 6, 32, 1, 3, 1, 160, 32, 2),
    (1, 0, 0, 1, 1): (1, 8, 16, 1, 2, 1, 128, 32, 2),
    (1, 0, 0, 2, 1): (1, 8, 16, 1, 2, 1, 160, 32, 2),
    (1, 0, 0, 1, 0): (1, 8, 8, 3, 3, 1, 128, 32, 2),
    (1, 0, 0, 2, 0): (1, 8, 8, 3, 3, 1, 160, 32, 2),
}


def up_tile(cin: int, cout: int, w: int) -> tuple:
    """The line that kernel U runs for a source `w` columns wide (a UP_BUILT
    value). ValueError if none is built, or for a Cout that is not a
    multiple of 8 (its weight rows are TMA rows of whole 16-byte pieces)."""
    line = pick_tile(UP_BUILT, tile_key(1, False, cin, cout, w))
    if cout % 8:
        raise ValueError(f"no conv kernel built for Cout {cout} "
                         f"(Cout % 8 != 0 with Cin {cin})")
    return line


def up_splits(cin: int, cout: int, h: int, w: int) -> int:
    """The runs that U splits its reduction into at an (h, w) source, as
    `conv.split_count` plans them with each source tile's four blocks (one
    a phase) counted: whatever the batch."""
    return split_count(up_tile(cin, cout, w), cin, cout, h, w, phases=4)


def workspace_shape(b: int, h: int, w: int, cin: int,
                    cout: int) -> Optional[Tuple[int, int, int]]:
    """The fp32 partials of a split call at a (B, h, w) source, (splits, B
    2h 2w, Cout), or None where the reduction is not split."""
    splits = up_splits(cin, cout, h, w)
    return None if splits == 1 else (splits, 4 * b * h * w, cout)


def _pair(k: torch.Tensor, axis: int, phase: int) -> torch.Tensor:
    """The 3 taps of `k` along `axis` summed into a phase's 2: [k0, k1 + k2]
    for phase 0, [k0 + k1, k2] for phase 1."""
    k0, k1, k2 = k.unbind(axis)
    return torch.stack([k0, k1 + k2] if phase == 0 else [k0 + k1, k2], axis)


def phase_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(Cout, Cin, 3, 3) OIHW -> (16, Cin, Cout) contiguous in `dtype`:
    phase-major ((a, b) = (0, 0), (0, 1), (1, 0), (1, 1)), then tap-major
    (2 r + c). The sums are taken in fp32, rows first, then columns, and
    cast once to `dtype`."""
    cout, cin = weight.shape[:2]
    k = weight.float().permute(2, 3, 1, 0)  # (3, 3, Cin, Cout)
    phases = [_pair(_pair(k, 0, a), 1, b) for a in (0, 1) for b in (0, 1)]
    return torch.stack(phases).reshape(16, cin, cout).to(dtype).contiguous()


def upconv3x3_plain(x: torch.Tensor, w16: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """The four 2x2 phase convs in fp32, each on the source grid with its
    phase's zero padding (phase 0 one row above, phase 1 one below;
    columns alike), interleaved into (B, 2H, 2W, Cout), plus the bias;
    result in x's dtype."""
    b, h, w, cin = x.shape
    cout = w16.shape[2]
    xc = x.float().permute(0, 3, 1, 2)
    k = w16.float().reshape(4, 2, 2, cin, cout).permute(0, 4, 3, 1, 2)
    ys = [F.conv2d(F.pad(xc, (1 - pb, pb, 1 - pa, pa)), k[2 * pa + pb])
          for pa in (0, 1) for pb in (0, 1)]
    y = torch.stack(ys).reshape(2, 2, b, cout, h, w)
    y = y.permute(2, 4, 0, 5, 1, 3).reshape(b, 2 * h, 2 * w, cout)
    return (y + bias.float()).to(x.dtype)


def upsample_conv_plain(x: torch.Tensor, w9: torch.Tensor,
                        bias: torch.Tensor, w16: torch.Tensor
                        ) -> torch.Tensor:
    """`UpConv3x3Fn`'s arguments through the plain version: the route's
    plain side, differentiable by torch autograd through w16 (w9 is not
    read)."""
    return upconv3x3_plain(x, w16, bias)


def _check(x, w16, bias):
    if x.dim() != 4 or w16.dim() != 3 or w16.shape[0] != 16:
        raise ValueError("x must be (B, H, W, Cin) and w16 (16, Cin, Cout)")
    if w16.shape[1] != x.shape[3]:
        raise ValueError(f"w16 has Cin {w16.shape[1]}, x has {x.shape[3]}")
    if tuple(bias.shape) != (w16.shape[2],):
        raise ValueError(f"bias must be ({w16.shape[2]},), got "
                         f"{tuple(bias.shape)}")
    if len({x.device, w16.device, bias.device}) != 1:
        raise ValueError("all operands must be on one device")


def _launch(x, w16, bias) -> torch.Tensor:
    """One launch of sg_upconv3x3 on checked operands, with the split
    reduction's workspace where the line splits it."""
    check_kernel_operands(x, w16)
    b, h, w, cin = x.shape
    cout = w16.shape[2]
    shape = workspace_shape(b, h, w, cin, cout)
    bias32 = _aligned(bias.float().contiguous())
    out = torch.empty((b, 2 * h, 2 * w, cout), dtype=x.dtype,
                      device=x.device)
    ws = None if shape is None else torch.empty(
        shape, dtype=torch.float32, device=x.device)
    err = _build.load().sg_upconv3x3(
        x.data_ptr(), w16.data_ptr(), bias32.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        1 if shape is None else shape[0], b, h, w, cin, cout,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "sg_upconv3x3")
    return out


def upconv3x3(x: torch.Tensor, w16: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, Cin), w16 (16, Cin, Cout) from `phase_weight`, bias
    (Cout) -> (B, 2H, 2W, Cout), the 3x3 SAME conv of x's nearest 2x
    upsampling. Launches kernel U for CUDA tensors and runs the plain
    version for CPU tensors."""
    _check(x, w16, bias)
    if x.device.type == "cpu":
        return upconv3x3_plain(x, w16, bias)
    out = _launch(x, w16, bias)
    upconv3x3.launches += 1
    return out


upconv3x3.launches = 0


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 2H, 2W, C), each pixel copied 2x2."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class UpConv3x3Fn(torch.autograd.Function):
    """Forward kernel U (`upconv3x3`) on w16; w9 is the same parameter
    packed as (9, Cin, Cout) and carries the weight's gradient (w16 gets
    none). Backward: dx by kernel C on the flipped w9 at the 2x grid,
    summed over each source pixel's 2x2 copies; dw plain on the upsampled
    x, formed only then; dbias plain. x is saved at its source size. A
    gradient that is not needed is not computed."""

    @staticmethod
    def forward(ctx, x, w9, bias, w16):
        out = upconv3x3(x, w16, bias)
        ctx.save_for_backward(x, w9)
        ctx.bias_dtype = bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, w9 = ctx.saved_tensors
        g = g.contiguous()
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        dx = dw = db = None
        if need_x:
            b, h, w, cin = x.shape
            zero = torch.zeros(cin, dtype=torch.float32, device=g.device)
            dup = conv3x3(g, flip_weight(w9), zero)
            dx = dup.float().reshape(b, h, 2, w, 2, cin).sum((2, 4)).to(
                x.dtype)
        if need_w:
            dw = conv3x3_dweight_plain(upsample_nearest(x), g).to(w9.dtype)
        if need_b:
            db = g.float().sum((0, 1, 2)).to(ctx.bias_dtype)
        return dx, dw, db, None
