"""Nearest 2x upsampling followed by a 3x3 SAME convolution over NHWC, in
its phase form: the wrappers of `csrc/upconv3x3.cu` (kernel U) and of its
input gradient `csrc/upconv_dx3x3.cu` (kernel UB), their plain PyTorch
versions, and the differentiable `UpConv3x3Fn`.

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

The backward is the phase form's too, as XLA differentiates the JAX
package's four phase convs. The input gradient is kernel UB
(`upconv3x3_dx`): each source pixel gathers the 16 taps through which the
four phase planes of the cotangent read it, which is the 4x4 stride-2
padding-1 correlation of the cotangent with the phase weights, taps
flipped and transposed (`dx_weight`; `packed_dx_weight` packs once per
phase-weight tensor: once for a frozen conv, once per backward for one
that trains). It sums in fp32 and rounds once; the (B, 2H, 2W, Cin)
gradient of an upsampled input never exists. UB runs kernel D's stride-2
walk of the wgmma template with a 4x4 window (mode PHASES_DX), in the
instantiations listed in `UB_BUILT`, picked by `dx_tile`, with C's split
of the reduction where the grid leaves the card short of blocks;
anything else raises ValueError. The weight gradient
(`upconv3x3_dweight_plain`, plain) forms the 16 tap products of the
source against the cotangent's phase planes and applies the adjoint of
the phase weights' tap sums; the bias gradient is plain.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from storygen_tpu_torch.ops import _build
from storygen_tpu_torch.ops.conv import (_aligned, check_kernel_operands,
                                         pick_tile, split_count, tile_key)

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


def dx_weight(w16: torch.Tensor) -> torch.Tensor:
    """(16, Cin, Cout) phase weights -> the (16, Cout, Cin) weights of UB's
    4x4 window, tap-major (4 ty + tx): per tap the (Cout, Cin) slice of
    the phase weights, taps flipped. Cotangent row 2r - 1 + ty lies in
    phase pa = (ty + 1) % 2, which reached source row r through its tap
    1 - ty // 2 (columns alike): ty = 2 (1 - r) + 1 - pa. Views and one
    copy (no index tensor, so no host-to-device transfer): w16 as (pa,
    pb, r, c) flipped on all four, then ordered (1 - r, 1 - pa, 1 - c,
    1 - pb)."""
    cin, cout = w16.shape[1:]
    k = w16.reshape(2, 2, 2, 2, cin, cout).flip(0, 1, 2, 3)
    return k.permute(2, 0, 3, 1, 5, 4).reshape(16, cout, cin).contiguous()


def packed_dx_weight(w16: torch.Tensor) -> torch.Tensor:
    """`dx_weight(w16)`, kept on the w16 tensor itself while w16 is
    unchanged: the module's cached phase weights of a frozen conv (every
    training stage's upsamplers) are packed for UB once, not at every
    backward; phase weights made afresh each step (a conv weight that
    trains) are packed once per backward."""
    memo = getattr(w16, "_ub_dx_weight", None)
    if memo is None or memo[0] != w16._version:
        memo = (w16._version, dx_weight(w16.detach()))
        w16._ub_dx_weight = memo
    return memo[1]


def upconv3x3_dx_plain(g: torch.Tensor, w16: torch.Tensor) -> torch.Tensor:
    """U's input gradient: g (B, 2H, 2W, Cout), w16 (16, Cin, Cout) -> (B,
    H, W, Cin) in g's dtype. 16 taps over g's four phase planes, in fp32:
    plane (a, b) is g[:, a::2, b::2], and source pixel (r, s) takes its
    pixel (r - a + u, s - b + v) through the phase's tap (1 - u, 1 - v),
    u, v in {0, 1}, an index outside the plane reading 0."""
    b, h2, w2, cout = g.shape
    cin = w16.shape[1]
    k = w16.float().reshape(4, 2, 2, cin, cout)
    dx = 0
    for pa in (0, 1):
        for pb in (0, 1):
            plane = g[:, pa::2, pb::2].float().permute(0, 3, 1, 2)
            kk = k[2 * pa + pb].flip(0, 1).permute(2, 3, 0, 1)
            dx = dx + F.conv2d(F.pad(plane, (pb, 1 - pb, pa, 1 - pa)), kk)
    return dx.permute(0, 2, 3, 1).to(g.dtype)


def _unpair(d: torch.Tensor, axis: int, phase: int) -> torch.Tensor:
    """The adjoint of `_pair`: a phase's 2 taps along `axis` back onto the
    3 they summed, [d0, d1, d1] for phase 0, [d0, d0, d1] for phase 1."""
    d0, d1 = d.unbind(axis)
    return torch.stack([d0, d1, d1] if phase == 0 else [d0, d0, d1], axis)


def phase_weight_adjoint(d16: torch.Tensor) -> torch.Tensor:
    """(16, Cin, Cout) gradient of the phase weights -> the (9, Cin, Cout)
    gradient of the packed 3x3 weight: the adjoint of `phase_weight`'s tap
    sums, summed over the four phases."""
    _, cin, cout = d16.shape
    d = d16.reshape(4, 2, 2, cin, cout)
    k = sum(_unpair(_unpair(d[2 * a + b], 1, b), 0, a)
            for a in (0, 1) for b in (0, 1))
    return k.reshape(9, cin, cout)


def upconv3x3_dweight_plain(x: torch.Tensor,
                            g: torch.Tensor) -> torch.Tensor:
    """(9, Cin, Cout) weight gradient of U, fp32, in phase form: the 16 tap
    products of the source x (B, H, W, Cin) against g's (B, 2H, 2W, Cout)
    phase planes, phase (a, b)'s tap (r, c) reading source pixel (y - 1 + a
    + r, x - 1 + b + c), then `phase_weight_adjoint`. The upsampled input
    never exists."""
    b, h, w, cin = x.shape
    cout = g.shape[3]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    d16 = []
    for pa in (0, 1):
        for pb in (0, 1):
            plane = g[:, pa::2, pb::2].float().reshape(-1, cout)
            for r in (0, 1):
                for c in (0, 1):
                    piece = xp[:, pa + r:pa + r + h, pb + c:pb + c + w]
                    d16.append(piece.reshape(-1, cin).t() @ plane)
    return phase_weight_adjoint(torch.stack(d16))


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

# The instantiations of kernel UB in csrc/upconv_dx3x3.cu (its SG_BUILT
# lines), keyed and valued as ops/downconv.py's DOWN_BUILT (stride 2; Cin
# the cotangent's channels, Cout and the W class the output's), each a
# 4x4-window line of the wgmma template: at Cout class 1 the fastest of
# studies/conv_tiles.py's candidates at the training path's up blocks, at
# class 2 (160-column tiles, no such site) the class-1 tile that fits.
UB_BUILT = {
    (2, 0, 0, 1, 2): (1, 8, 32, 1, 2, 2, 128, 16, 2),
    (2, 0, 0, 2, 2): (1, 8, 16, 1, 2, 1, 160, 16, 2),
    (2, 0, 0, 1, 1): (1, 8, 16, 1, 2, 1, 128, 16, 2),
    (2, 0, 0, 2, 1): (1, 8, 16, 1, 2, 1, 160, 16, 2),
    (2, 0, 0, 1, 0): (1, 8, 8, 2, 2, 1, 128, 16, 2),
    (2, 0, 0, 2, 0): (1, 8, 8, 2, 2, 1, 160, 16, 2),
}


def dx_tile(cin: int, cout: int, w: int) -> tuple:
    """The line that kernel UB runs for a cotangent of `cin` channels and a
    (B, H, `w`, `cout`) gradient (a UB_BUILT value). ValueError if none is
    built, or for a Cout that is not a multiple of 8."""
    line = pick_tile(UB_BUILT, tile_key(2, False, cin, cout, w))
    if cout % 8:
        raise ValueError(f"no conv kernel built for Cout {cout} "
                         f"(Cout % 8 != 0 with Cin {cin})")
    return line


def dx_splits(cin: int, cout: int, h: int, w: int,
              line: Optional[tuple] = None) -> int:
    """The runs that UB splits its 16 Cin reduction into at an (h, w)
    output (`line`, UB's built one if None), as `conv.split_count` plans
    them: whatever the batch."""
    line = dx_tile(cin, cout, w) if line is None else line
    return split_count(line, cin, cout, h, w)


def _check_dx(g, w16):
    if g.dim() != 4 or w16.dim() != 3 or w16.shape[0] != 16:
        raise ValueError("g must be (B, 2H, 2W, Cout) and w16 (16, Cin, "
                         "Cout)")
    if g.shape[1] % 2 or g.shape[2] % 2:
        raise ValueError(f"g must have an even height and width, got "
                         f"{tuple(g.shape)}")
    if w16.shape[2] != g.shape[3]:
        raise ValueError(f"w16 has Cout {w16.shape[2]}, g has {g.shape[3]}")
    if g.device != w16.device:
        raise ValueError("all operands must be on one device")


def _launch_dx(g, k16, lib=None, line=None) -> torch.Tensor:
    """One launch of sg_upconv_dx3x3 from `lib` (the built library if None;
    the tile study passes one built with another SG_BUILT line, and that
    line as `line`) on g and the packed `k16` (`dx_weight`), with the
    split reduction's workspace where the line splits it."""
    check_kernel_operands(g, k16)
    b, h2, w2, cin = g.shape
    h, w, cout = h2 // 2, w2 // 2, k16.shape[2]
    splits = dx_splits(cin, cout, h, w, line)
    out = torch.empty((b, h, w, cout), dtype=g.dtype, device=g.device)
    ws = None if splits == 1 else torch.empty(
        (splits, b * h * w, cout), dtype=torch.float32, device=g.device)
    err = (lib or _build.load()).sg_upconv_dx3x3(
        g.data_ptr(), k16.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), splits, b, h, w, cin, cout,
        torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, "sg_upconv_dx3x3")
    return out


def upconv3x3_dx(g: torch.Tensor, w16: torch.Tensor) -> torch.Tensor:
    """g (B, 2H, 2W, Cout), the cotangent of `upconv3x3`'s output, and its
    w16 (16, Cin, Cout) -> (B, H, W, Cin), the gradient of its input, in
    g's dtype. Launches kernel UB (on `packed_dx_weight(w16)`) for CUDA
    tensors and runs the plain version for CPU tensors."""
    _check_dx(g, w16)
    if g.device.type == "cpu":
        return upconv3x3_dx_plain(g, w16)
    out = _launch_dx(g, packed_dx_weight(w16))
    upconv3x3_dx.launches += 1
    return out


upconv3x3_dx.launches = 0


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 2H, 2W, C), each pixel copied 2x2."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class UpConv3x3Fn(torch.autograd.Function):
    """Forward kernel U (`upconv3x3`) on w16; w9 is the same parameter
    packed as (9, Cin, Cout) and carries the weight's gradient (w16 gets
    none). Backward in phase form: dx by kernel UB (`upconv3x3_dx`) on
    w16, one fp32 sum rounded once; dw plain from the 16 tap products of
    x and g's phase planes (`upconv3x3_dweight_plain`); dbias plain. x is
    saved at its source size, w16 beside w9. A gradient that is not needed
    is not computed."""

    @staticmethod
    def forward(ctx, x, w9, bias, w16):
        out = upconv3x3(x, w16, bias)
        ctx.save_for_backward(x, w9, w16)
        ctx.bias_dtype = bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, w9, w16 = ctx.saved_tensors
        g = g.contiguous()
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        dx = dw = db = None
        if need_x:
            dx = upconv3x3_dx(g, w16).to(x.dtype)
        if need_w:
            dw = upconv3x3_dweight_plain(x, g).to(w9.dtype)
        if need_b:
            db = g.float().sum((0, 1, 2)).to(ctx.bias_dtype)
        return dx, dw, db, None
