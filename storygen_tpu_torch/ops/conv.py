"""3x3 stride-1 SAME convolution over NHWC: the wrappers of the two
instantiations of `csrc/conv3x3.cu`, their plain PyTorch versions, and the
differentiable `Conv3x3Fn` and `GnConv3x3Fn`.

Kernel C (`conv3x3`) replaces `_kernel` (fused=False) of
storygen_tpu/ops/pallas_conv.py (reached through `halo_conv` / `conv3x3`):
fp32 accumulation, a (Cout) or per-batch (B, Cout) fp32 bias, and an
optional residual added in the epilogue. Weights come packed as
(9, Cin, Cout), tap-major (3*dy + dx). Kernel P (`gnconv3x3`) replaces the
same `_kernel` with fused=True (reached through `gnconv3x3` /
`gnconvres3x3`): kernel C on silu(x * a + s), the resnet's folded GroupNorm
and SiLU, applied where the kernel loads its input (border kept 0).

Both run the templates listed in `CONV_BUILT`, picked by `conv_tile` from
the stride, the prologue, Cin % 8, a Cout class and the output width:
`csrc/conv_wgmma.cuh` (wgmma fed by TMA) wherever Cin % 8 == 0 and Cout >
16, `csrc/conv_mma.cuh` (mma.sync) at the conv_in and conv_out keys;
anything else raises ValueError. At the few-pixel sites the wgmma lines
split the 9 Cin reduction (`conv_splits`, a function of the shape without
the batch) into fp32 partials that the wrapper allocates
(`workspace_shape`) and the kernel adds in one order.

The backward of C follows `_conv3x3_bwd` of the JAX module: the input
gradient reuses kernel C on the spatially flipped, in/out-transposed
weight; the weight and bias gradients are plain. That of P follows
`_gnconv3x3_bwd`: it recomputes the prologue in fp32, takes the gradient
of the activation from kernel C, and the rest plain.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from storygen_tpu_torch.ops import _build

# The instantiations of kernels C and P in csrc/conv3x3.cu (its SG_BUILT
# lines): (stride, prologue, Cin % 8 != 0, Cout class, W class) ->
# (family, then its eight tile parameters). Family MMA is conv_mma.cuh's
# mma.sync template, (TH, TW, BN, warps along M, warps along N, CK, ring
# stages, blocks per SM); family WGMMA conv_wgmma.cuh's, (TH, TW, images a
# block, consumer warpgroups, 64-row tiles a warpgroup, BN, CK, ring
# stages): an output tile of TH x TW pixels (of IB images) by BN channels,
# Cin walked in chunks of CK. The Cout class is 0 for Cout <= 16, 2 for a
# Cout that 128 does not divide where Cin % 8 == 0 and Cout > 16
# (160-column tiles: 320 = 2 x 160), else 1; the W class of the output
# width is 0 for W <= 8, 1 for W <= 16, else 2. P takes C's line at every
# key: with the same tile, chunk depth and splits both sum their products
# in one order (split, chunk, tap, 16-channel step), so P on a slab equals
# C on the prologue applied beforehand, bit for bit.
MMA, WGMMA = 0, 1
CONV_BUILT = {
    (1, 0, 0, 1, 2): (WGMMA, 6, 32, 1, 3, 1, 128, 32, 2),
    (1, 0, 0, 2, 2): (WGMMA, 6, 32, 1, 3, 1, 160, 32, 2),
    (1, 0, 0, 1, 1): (WGMMA, 8, 16, 1, 2, 1, 128, 32, 2),
    (1, 0, 0, 2, 1): (WGMMA, 8, 16, 1, 2, 1, 160, 32, 2),
    (1, 0, 0, 1, 0): (WGMMA, 8, 8, 3, 3, 1, 128, 32, 2),
    (1, 0, 0, 2, 0): (WGMMA, 8, 8, 3, 3, 1, 160, 32, 2),
    (1, 0, 0, 0, 2): (MMA, 16, 16, 16, 8, 1, 32, 2, 1),
    (1, 0, 0, 0, 1): (MMA, 8, 16, 16, 4, 1, 32, 2, 4),
    (1, 0, 0, 0, 0): (MMA, 8, 8, 16, 4, 1, 32, 2, 4),
    (1, 0, 1, 1, 2): (MMA, 8, 16, 64, 4, 2, 16, 2, 2),
    (1, 0, 1, 1, 1): (MMA, 8, 16, 64, 4, 2, 16, 2, 2),
    (1, 0, 1, 1, 0): (MMA, 8, 16, 64, 4, 2, 16, 2, 2),
    (1, 0, 1, 0, 2): (MMA, 8, 16, 16, 4, 1, 16, 2, 4),
    (1, 0, 1, 0, 1): (MMA, 8, 16, 16, 4, 1, 16, 2, 4),
    (1, 0, 1, 0, 0): (MMA, 8, 16, 16, 4, 1, 16, 2, 4),
    (1, 1, 0, 1, 2): (WGMMA, 6, 32, 1, 3, 1, 128, 32, 2),
    (1, 1, 0, 2, 2): (WGMMA, 6, 32, 1, 3, 1, 160, 32, 2),
    (1, 1, 0, 1, 1): (WGMMA, 8, 16, 1, 2, 1, 128, 32, 2),
    (1, 1, 0, 2, 1): (WGMMA, 8, 16, 1, 2, 1, 160, 32, 2),
    (1, 1, 0, 1, 0): (WGMMA, 8, 8, 3, 3, 1, 128, 32, 2),
    (1, 1, 0, 2, 0): (WGMMA, 8, 8, 3, 3, 1, 160, 32, 2),
}
# The card's SMs, and the batch that the split plan assumes (the UNet's
# 3-row CFG batch): constants, so that a shape's split never depends on the
# batch it comes with.
SMS = 132
PLAN_BATCH = 3


def tile_key(stride: int, prologue: bool, cin: int, cout: int,
             wo: int) -> Tuple[int, int, int, int, int]:
    """The key under which the conv kernels (C, P and D) pick their
    instantiation, as csrc/conv_wgmma.cuh's conv_cout_class and
    conv_mma.cuh's w_class do: (stride, prologue, Cin % 8 != 0, Cout
    class, W class of the output width). It holds no batch."""
    if cout <= 16:
        coutc = 0
    elif cin % 8 == 0 and cout % 128:
        coutc = 2
    else:
        coutc = 1
    return (int(stride), int(bool(prologue)), int(cin % 8 != 0), coutc,
            0 if wo <= 8 else (1 if wo <= 16 else 2))


def pick_tile(built: dict, key: tuple) -> tuple:
    """The instantiation that `built` lists under `key`; ValueError if
    none is built."""
    if key not in built:
        raise ValueError(f"no conv kernel built for (stride, prologue, "
                         f"narrow Cin, Cout class, W class) = {key}")
    return built[key]


def conv_tile(prologue: bool, cin: int, cout: int, w: int) -> tuple:
    """The line that kernel C (P where `prologue`) runs: (family, then its
    tile; see CONV_BUILT). ValueError if none is built, or for a wgmma
    line's Cout that is not a multiple of 8 (its weight rows are TMA rows
    of whole 16-byte pieces)."""
    line = pick_tile(CONV_BUILT, tile_key(1, prologue, cin, cout, w))
    if line[0] == WGMMA and cout % 8:
        raise ValueError(f"no conv kernel built for Cout {cout} "
                         f"(Cout % 8 != 0 with Cin {cin})")
    return line


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def split_count(line: tuple, cin: int, cout: int, h: int, w: int,
                phases: int = 1) -> int:
    """How many runs of whole CK-channel chunks `line` splits the 9 Cin
    reduction into at a site of C, P or D with an (H, W) output, Cin and
    Cout (kernel U: its 4 Cin reduction at an (H, W) source, whose tiles
    each take `phases` 4 blocks): 1 on a mma.sync line, and
    on a wgmma line wherever PLAN_BATCH images give half the SMs a block or
    more; else as many as fill the SMs, at least two chunks a run. A
    function of the line and the shape alone: every batch sums in one
    order."""
    fam, th, tw, ib, _, _, bn, ck, _ = line
    if fam != WGMMA:
        return 1
    blocks = (phases * _ceil(PLAN_BATCH, ib) * _ceil(h, th) * _ceil(w, tw)
              * _ceil(cout, bn))
    if blocks >= SMS // 2:
        return 1
    return max(1, min(_ceil(SMS, blocks), _ceil(cin, ck) // 2))


def conv_splits(prologue: bool, cin: int, cout: int, h: int,
                w: int) -> int:
    """`split_count` of the line that kernel C (P) runs at the site."""
    return split_count(conv_tile(prologue, cin, cout, w), cin, cout, h, w)


def workspace_shape(prologue: bool, b: int, h: int, w: int, cin: int,
                    cout: int, line: Optional[tuple] = None
                    ) -> Optional[Tuple[int, int, int]]:
    """The fp32 partials of a split call, (splits, B H W, Cout) with (H, W)
    the output's size, or None where the reduction is not split; `line` is
    C's (P's) built one if None (D passes its own)."""
    line = conv_tile(prologue, cin, cout, w) if line is None else line
    splits = split_count(line, cin, cout, h, w)
    return None if splits == 1 else (splits, b * h * w, cout)


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


def silu_affine(x: torch.Tensor, a: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """P's prologue in fp32: silu(x * a + s), a and s (B, Cin) broadcast over
    (B, H, W, Cin)."""
    z = x.float() * a.float()[:, None, None, :] + s.float()[:, None, None, :]
    return F.silu(z)


def gnconv3x3_plain(x: torch.Tensor, w9: torch.Tensor, bias: torch.Tensor,
                    a: torch.Tensor, s: torch.Tensor,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The prologue in fp32, rounded to x's dtype (where the unfused
    GroupNorm casts its result and the kernel rounds its slab), then
    `conv3x3_plain`."""
    return conv3x3_plain(silu_affine(x, a, s).to(x.dtype), w9, bias,
                         residual)


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


def check_kernel_operands(x, w9, residual=None):
    """What the conv kernels (C, P and D) take on the card: bf16,
    contiguous, 16-byte aligned x, w9 and residual, and no empty extent."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    ops = [x, w9] + ([] if residual is None else [residual])
    if any(t.dtype != torch.bfloat16 for t in ops):
        raise ValueError("the kernel takes bfloat16 x, w9 and residual")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("x, w9 and residual must be contiguous")
    if any(t.data_ptr() % 16 for t in ops):
        raise ValueError("x, w9 and residual must be 16-byte aligned")
    if x.numel() == 0 or w9.shape[2] == 0:
        raise ValueError("empty convolution")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy where it does not start on 16 bytes (the kernels read
    the bias, a and s 16 or 8 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, x, w9, bias, residual, *affine, lib=None,
            line=None) -> torch.Tensor:
    """Launch `name` (sg_conv3x3, or sg_gnconv3x3 with its fp32 (a, s)) on
    checked operands; the bias and a, s go to the kernel as fp32, with the
    split reduction's workspace where the line splits it. `lib` is the
    built library and `line` its line at this key if None (the tile study
    passes a library built with another SG_BUILT line, and that line)."""
    check_kernel_operands(x, w9, residual)
    b, h, w, cin = x.shape
    cout = w9.shape[2]
    pro = bool(affine)
    if line is None:
        line = conv_tile(pro, cin, cout, w)
    shape = workspace_shape(pro, b, h, w, cin, cout, line)
    bias32 = _aligned(bias.float().contiguous())
    affine32 = [_aligned(t.float().contiguous()) for t in affine]
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    ws = None if shape is None else torch.empty(
        shape, dtype=torch.float32, device=x.device)
    err = getattr(lib or _build.load(), name)(
        x.data_ptr(), w9.data_ptr(), bias32.data_ptr(),
        cout if bias.dim() == 2 else 0, *(t.data_ptr() for t in affine32),
        None if residual is None else residual.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        1 if shape is None else shape[0], b, h, w, cin, cout,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)
    return out


def conv3x3(x: torch.Tensor, w9: torch.Tensor, bias: torch.Tensor,
            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, H, W, Cin), w9 (9, Cin, Cout), bias (Cout) or (B, Cout),
    residual (B, H, W, Cout) or None -> (B, H, W, Cout). Launches kernel C
    for CUDA tensors and runs the plain version for CPU tensors."""
    _check(x, w9, bias, residual)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w9, bias, residual)
    out = _launch("sg_conv3x3", x, w9, bias, residual)
    conv3x3.launches += 1
    return out


conv3x3.launches = 0


def gnconv3x3(x: torch.Tensor, w9: torch.Tensor, bias: torch.Tensor,
              a: torch.Tensor, s: torch.Tensor,
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv3x3(silu(x * a + s)) + bias (+ residual): x (B, H, W, Cin), a
    and s (B, Cin), the rest as `conv3x3`. Launches kernel P for CUDA
    tensors and runs the plain version for CPU tensors."""
    _check(x, w9, bias, residual)
    if tuple(a.shape) != (x.shape[0], x.shape[3]) or a.shape != s.shape:
        raise ValueError(f"a and s must be {(x.shape[0], x.shape[3])}, got "
                         f"{tuple(a.shape)} and {tuple(s.shape)}")
    if a.device != x.device or s.device != x.device:
        raise ValueError("all operands must be on one device")
    if x.device.type == "cpu":
        return gnconv3x3_plain(x, w9, bias, a, s, residual)
    out = _launch("sg_gnconv3x3", x, w9, bias, residual, a, s)
    gnconv3x3.launches += 1
    return out


gnconv3x3.launches = 0


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


class GnConv3x3Fn(torch.autograd.Function):
    """Forward kernel P (`gnconv3x3`). Backward as `_gnconv3x3_bwd`: the
    prologue recomputed in fp32 from the saved x, a and s (the activation is
    not saved); dact by kernel C on the flipped weight; then dz = dact *
    silu'(z), dx = dz * a, da = sum(dz * x), ds = sum(dz), dw plain on the
    activation, dbias, and the residual's gradient g. A gradient that is
    not needed is not computed."""

    @staticmethod
    def forward(ctx, x, w9, bias, a, s, residual):
        out = gnconv3x3(x, w9, bias, a, s, residual)
        ctx.save_for_backward(x, w9, a, s)
        ctx.bias_shape, ctx.bias_dtype = bias.shape, bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, w9, a, s = ctx.saved_tensors
        g = g.contiguous()
        need_x, need_w, need_b, need_a, need_s, need_r = ctx.needs_input_grad
        dx = dw = db = da = ds = None
        a4, s4 = a.float()[:, None, None, :], s.float()[:, None, None, :]
        z = x.float() * a4 + s4
        sig = torch.sigmoid(z)
        if need_x or need_a or need_s:
            zero = torch.zeros(x.shape[-1], dtype=torch.float32,
                               device=g.device)
            dact = conv3x3(g, flip_weight(w9), zero)
            dz = dact.float() * (sig * (1.0 + z * (1.0 - sig)))
            if need_x:
                dx = (dz * a4).to(x.dtype)
            if need_a:
                da = (dz * x.float()).sum((1, 2)).to(a.dtype)
            if need_s:
                ds = dz.sum((1, 2)).to(s.dtype)
        if need_w:
            dw = conv3x3_dweight_plain((z * sig).to(x.dtype), g).to(w9.dtype)
        if need_b:
            dims = (1, 2) if len(ctx.bias_shape) == 2 else (0, 1, 2)
            db = g.float().sum(dims).to(ctx.bias_dtype)
        return dx, dw, db, da, ds, g if need_r else None
