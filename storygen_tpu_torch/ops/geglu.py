"""Fused GEGLU -> output GEMM: wrapper of `csrc/geglu_matmul.cu`, its
plain PyTorch version, and the differentiable `GegluMatmulFn`.

Replaces `_geglu_kernel` of storygen_tpu/ops/pallas_geglu.py (reached
through `geglu_matmul`). From the packed projection proj (M, 2N) =
[value | gate] it computes (value * gelu_erf(gate)) @ weight.T + bias, where
weight is the nn.Linear weight (E, N); the gated product never reaches
memory in the kernel. `GEGLU_BUILT` mirrors the kernel's instantiations
and `geglu_tile` picks one per (M, N, E). The backward is plain fp32
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
                       bias: torch.Tensor) -> torch.Tensor:
    """fp32 gate, the gated product rounded to proj's dtype (as the kernel
    rounds its A operand), fp32 GEMM and bias, result in proj's dtype."""
    n = proj.shape[-1] // 2
    value, gate = proj[..., :n].float(), proj[..., n:].float()
    gated = (value * F.gelu(gate)).to(proj.dtype).float()
    out = gated @ weight.float().t() + bias.float()
    return out.to(proj.dtype)


# The instantiations of kernel G in csrc/geglu_matmul.cu (its SG_BUILT
# lines, in their order): (E, m_class(M), K step) -> (BM, BE, BK, warps
# along M, warps along E, cp.async ring stages, split-K). Of the lines of
# one (E, M class) the first whose K step divides N runs: the K step 32
# only where N is not a multiple of 64 (the first level at tensor
# parallelism 8, N = 1280 / 8 = 160).
GEGLU_BUILT = {
    (320, 0, 64): (32, 320, 64, 1, 4, 3, 4),
    (320, 1, 64): (32, 320, 64, 1, 4, 3, 1),
    (320, 2, 64): (64, 320, 64, 2, 4, 3, 1),
    (320, 2, 32): (128, 320, 32, 2, 4, 3, 1),
    (640, 0, 64): (32, 320, 64, 1, 4, 3, 4),
    (640, 1, 64): (32, 320, 64, 1, 4, 3, 2),
    (640, 2, 64): (64, 320, 64, 2, 4, 3, 1),
    (1280, 0, 64): (32, 128, 64, 1, 4, 3, 4),
    (1280, 1, 64): (64, 256, 64, 2, 4, 3, 2),
    (1280, 2, 64): (128, 256, 64, 2, 4, 3, 1),
}


def m_class(m: int) -> int:
    """The class of M that picks an instantiation together with E (the
    source's m_class): 0 up to 512 rows (the mid block), 1 up to 2048 (the
    third level), 2 above."""
    return 0 if m <= 512 else (1 if m <= 2048 else 2)


def tile_key(m: int, n: int, e: int) -> Tuple[int, int, int]:
    """The GEGLU_BUILT key that kernel G runs for proj (m, 2n) and weight
    (e, n): the first built line of (e, m_class(m)) whose K step divides
    n. ValueError if (e, m_class(m)) has no line, or none divides n."""
    steps = [k[2] for k in GEGLU_BUILT if k[:2] == (e, m_class(m))]
    if not steps:
        raise ValueError(f"no GEGLU kernel built for E={e}, M={m}")
    for bk in steps:
        if n % bk == 0:
            return e, m_class(m), bk
    raise ValueError(f"inner width {n} must be a multiple of the K step "
                     f"{steps[-1]}")


def geglu_tile(m: int, n: int, e: int) -> Tuple[int, ...]:
    """The instantiation that kernel G runs for proj (m, 2n) and weight
    (e, n): (BM, BE, BK, WM, WE, stages, split); its grid is
    (ceil(e / BE), ceil(m / BM), split). ValueError if none is built for
    these widths (`tile_key`)."""
    return GEGLU_BUILT[tile_key(m, n, e)]


# Per (device, stream): the split-K tiles' arrival counters. Zeroed once;
# every launch leaves them zeroed, and launches on one stream never overlap.
_counters = {}


def _tile_counters(device: torch.device, stream: int, n: int
                   ) -> torch.Tensor:
    buf = _counters.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[(device, stream)] = buf
    return buf


def _launch(proj, weight, bias, lib=None, tile=None) -> torch.Tensor:
    """One launch of sg_geglu_matmul from `lib` (the built library if
    None; the tile study passes one built with other SG_BUILT lines and
    that line's `tile`)."""
    m, e, n = proj.shape[0], *weight.shape
    tile = tile or geglu_tile(m, n, e)
    bm, be, split = tile[0], tile[1], tile[6]
    stream = torch.cuda.current_stream(proj.device).cuda_stream
    out = torch.empty((m, e), dtype=proj.dtype, device=proj.device)
    part = count = None
    if split > 1:
        part = torch.empty((split, m, e), dtype=torch.float32,
                           device=proj.device)
        count = _tile_counters(proj.device, stream,
                               -(-m // bm) * -(-e // be))
    err = (lib or _build.load()).sg_geglu_matmul(
        proj.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        int(bias.dtype == torch.float32), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if count is None else count.data_ptr(), m, n, e, stream)
    _build.check(err, "sg_geglu_matmul")
    return out


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
    if bias.dtype not in (torch.bfloat16, torch.float32):
        bias = bias.float()  # the kernel reads a bf16 or fp32 bias as it is
    out = _launch(proj, weight, bias.contiguous())
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
