"""Fused GEGLU -> output GEMM: wrapper of `csrc/geglu_matmul.cu`, its
plain PyTorch version, and the differentiable `GegluMatmulFn`.

Replaces `_geglu_kernel` of storygen_tpu/ops/pallas_geglu.py (reached
through `geglu_matmul`). From the packed projection proj (M, 2N) =
[value | gate] it computes (value * gelu_erf(gate)) @ weight.T + bias, where
weight is the nn.Linear weight (E, N); the gated product never reaches
memory in the kernel. `GEGLU_BUILT` mirrors the kernel's instantiations
and `geglu_tile` picks one per (rows per image, N, E), never by the batch,
so every row sums in one order whatever M is. The backward is plain fp32
torch (`_bwd` of the JAX module, which runs in XLA outside any Pallas
kernel).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from storygen_tpu_torch.ops import _build


def geglu_matmul_plain(proj: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, tokens: Optional[int] = None
                       ) -> torch.Tensor:
    """fp32 gate, the gated product rounded to proj's dtype (as the kernel
    rounds its A operand), fp32 GEMM and bias, result in proj's dtype;
    `tokens` (the kernel's rows per image) changes nothing here."""
    n = proj.shape[-1] // 2
    value, gate = proj[..., :n].float(), proj[..., n:].float()
    gated = (value * F.gelu(gate)).to(proj.dtype).float()
    out = gated @ weight.float().t() + bias.float()
    return out.to(proj.dtype)


# The instantiations of kernel G in csrc/geglu_matmul.cu (its SG_BUILT
# lines, in their order): (E, site_class(tokens), K step) -> (consumer
# warpgroups, BE, WN, BK, TMA ring stages, split), all on the wgmma
# template of csrc/geglu_wgmma.cuh: a block of 64 x warpgroups rows by BE
# output columns as BE / WN products, inner steps of BK columns, the N
# reduction split into at most `split` runs (`split_count`). Of the lines
# of one (E, site class) the first whose K step divides N runs: the K step
# 32 only where N is not a multiple of 64 (the first level at tensor
# parallelism 8, N = 1280 / 8 = 160).
GEGLU_BUILT = {
    (320, 0, 64): (1, 320, 160, 64, 4, 8),
    (320, 1, 64): (1, 320, 160, 64, 4, 2),
    (320, 2, 64): (2, 320, 160, 64, 3, 1),
    (320, 2, 32): (2, 320, 160, 32, 6, 1),
    (640, 0, 64): (1, 320, 160, 64, 4, 8),
    (640, 1, 64): (1, 320, 160, 64, 4, 2),
    (640, 2, 64): (1, 320, 160, 64, 4, 1),
    (1280, 0, 64): (1, 256, 256, 64, 4, 4),
    (1280, 1, 64): (1, 320, 160, 64, 4, 2),
    (1280, 2, 64): (1, 320, 160, 64, 4, 1),
}


def site_class(tokens: int) -> int:
    """The class of a site's rows per image that picks an instantiation
    together with E (the source's site_class): 0 up to 128 (the mid
    block's 64 at 512 px), 1 up to 512 (the third level's 256), 2 above.
    The batch never enters it."""
    return 0 if tokens <= 128 else (1 if tokens <= 512 else 2)


def tile_key(tokens: int, n: int, e: int) -> Tuple[int, int, int]:
    """The GEGLU_BUILT key that kernel G runs for weight (e, n) at a site
    of `tokens` rows per image: the first built line of (e,
    site_class(tokens)) whose K step divides n. ValueError if (e, site
    class) has no line, or none divides n."""
    steps = [k[2] for k in GEGLU_BUILT if k[:2] == (e, site_class(tokens))]
    if not steps:
        raise ValueError(f"no GEGLU kernel built for E={e}, {tokens} rows "
                         f"per image")
    for bk in steps:
        if n % bk == 0:
            return e, site_class(tokens), bk
    raise ValueError(f"inner width {n} must be a multiple of the K step "
                     f"{steps[-1]}")


def geglu_tile(tokens: int, n: int, e: int) -> Tuple[int, ...]:
    """The instantiation that kernel G runs for weight (e, n) at a site of
    `tokens` rows per image: (consumer warpgroups, BE, WN, BK, stages,
    split); its grid is (ceil(e / BE), ceil(M / (64 warpgroups)),
    split_count(tile, n)) in clusters of the split's blocks. ValueError if
    none is built for these widths (`tile_key`)."""
    return GEGLU_BUILT[tile_key(tokens, n, e)]


def split_count(tile: Tuple[int, ...], n: int) -> int:
    """How many runs of whole BK steps `tile` splits the N reduction into
    (the source's split_count): its split (at most 8, a cluster's portable
    size), but at least 4 steps a run. A function of the line and N alone,
    so every batch sums in one order."""
    bk, split = tile[3], tile[5]
    return min(split, max(1, n // bk // 4))


def _launch(proj, weight, bias, tokens, lib=None) -> torch.Tensor:
    """One launch of sg_geglu_matmul from `lib` (the built library if
    None; the tile study passes one built with other SG_BUILT lines)."""
    m, e, n = proj.shape[0], *weight.shape
    out = torch.empty((m, e), dtype=proj.dtype, device=proj.device)
    err = (lib or _build.load()).sg_geglu_matmul(
        proj.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        int(bias.dtype == torch.float32), out.data_ptr(), m, n, e, tokens,
        torch.cuda.current_stream(proj.device).cuda_stream)
    _build.check(err, "sg_geglu_matmul")
    return out


def geglu_matmul(proj: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor, tokens: Optional[int] = None
                 ) -> torch.Tensor:
    """proj (M, 2N), weight (E, N), bias (E) -> (M, E); `tokens` is the
    rows per image of the site (M if None: one image), which with E and N
    picks the kernel's tile and split, so a row's result does not depend
    on how many images share the call. Launches the CUDA kernel for CUDA
    tensors and runs the plain version for CPU tensors."""
    if proj.dim() != 2 or weight.dim() != 2 or bias.dim() != 1:
        raise ValueError("proj must be (M, 2N), weight (E, N), bias (E)")
    m, n2 = proj.shape
    e, n = weight.shape
    if n2 != 2 * n or bias.shape[0] != e:
        raise ValueError(f"shape mismatch proj {tuple(proj.shape)} weight "
                         f"{tuple(weight.shape)} bias {tuple(bias.shape)}")
    if not (proj.device == weight.device == bias.device):
        raise ValueError("proj, weight, bias must be on one device")
    tokens = m if tokens is None else int(tokens)
    if tokens < 1:
        raise ValueError(f"rows per image must be positive, got {tokens}")
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
    if bias.dtype not in (torch.bfloat16, torch.float32):
        bias = bias.float()  # the kernel reads a bf16 or fp32 bias as it is
    out = _launch(proj, weight, bias.contiguous(), tokens)
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
    def forward(ctx, proj, weight, bias, tokens=None):
        out = geglu_matmul(proj, weight, bias, tokens)
        ctx.save_for_backward(proj, weight)
        ctx.bias_dtype = bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        proj, weight = ctx.saved_tensors
        dproj, dw, db = geglu_matmul_bwd_plain(proj, weight, g,
                                               *ctx.needs_input_grad[:3])
        return (dproj, dw, None if db is None else db.to(ctx.bias_dtype),
                None)
