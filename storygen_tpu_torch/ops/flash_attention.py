"""Flash attention, forward and backward: wrappers of `csrc/flash_fwd.cu`
and `csrc/flash_bwd.cu`, their plain PyTorch versions, and the
differentiable `flash_attention`.

Replaces storygen_tpu/ops/pallas_attention.py. The forward kernels
(`_bnd2_kernel`, `_bnd_kernel`, `_online_t_kernel`, `_flash_kernel`, all
reached through `_flash_core`) become kernel F (`flash_fwd`), their masked
variants kernel M (`flash_fwd_masked`); the backward (`_core_bwd` ->
`_pallas_bwd_with_out`) becomes kernels L (`flash_lse`, F's walk in
`csrc/flash_wgmma.cuh` without V, P V and O), DQ (`flash_dq`) and DKV
(`flash_dkv`), tied together by `FlashAttentionFn`.

Inputs are the projections' own layout: q (B, Sq, H*D), k/v (B, Skv, H*D),
each with a contiguous last dimension (a k|v split view is taken as it is);
outputs and gradients are (B, S, H*D). `keep` (B, N) marks which of the N
equal kv spans (attn3's reference frames) each batch row may attend to; a
row that keeps no span attends to nothing and its output is 0.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors; it counts its launches in `<wrapper>.launches`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from storygen_tpu_torch.ops import _build

# 16-padded head dims the kernels are instantiated for: the UNet's 40, 80, 160
_PADDED_D = (48, 80, 160)
# K/V tile heights of the wgmma templates (Q K^T's N); a reference span
# need not be a multiple of one
WG_BK = (64, 128)
# The instantiations of kernels F and M (csrc/flash_fwd.cu's kFwd SG_BUILT
# lines, csrc/flash_wgmma.cuh's flash_wg_kernel): (16-padded head dim,
# masked) -> (BQ, BK, ring stages, Q / K panel columns (16, 32 or 64),
# ping-pong of its two consumer warpgroups (0 / 1)).
FWD_BUILT = {
    (48, False): (192, 128, 2, 64, 0),
    (48, True): (128, 128, 3, 64, 1),
    (80, False): (128, 128, 2, 64, 1),
    (80, True): (128, 128, 2, 64, 1),
    (160, False): (128, 64, 2, 32, 1),
    (160, True): (128, 64, 2, 32, 1),
}
# The instantiations of kernel L (csrc/flash_fwd.cu's kLse SG_BUILT lines,
# csrc/flash_wgmma.cuh's lse_wg_kernel): (16-padded head dim, masked) ->
# (BQ, BK, ring stages, Q / K panel columns).
LSE_BUILT = {
    (48, False): (128, 128, 4, 64), (48, True): (128, 128, 4, 64),
    (80, False): (128, 128, 3, 64), (80, True): (128, 128, 3, 64),
    (160, False): (128, 64, 3, 32), (160, True): (128, 64, 3, 32),
}
# The instantiations of kernels DQ and DKV in csrc/flash_bwd.cu (its
# SG_BUILT lines, csrc/flash_bwd_wgmma.cuh's template): (kernel, 16-padded
# head dim, masked) -> (BR, the block's own rows, 64 per consumer
# warpgroup; BC, the rows of a streamed tile; ring stages; own panel
# columns, 16, 32 or 64; ping-pong of two consumer warpgroups, 0 / 1).
# DQ's own rows are Q rows and its streamed tiles K/V; DKV's the other way
# round.
BWD_BUILT = {
    ("dq", 48, False): (128, 128, 4, 64, 1),
    ("dq", 48, True): (128, 128, 4, 64, 1),
    ("dq", 80, False): (128, 64, 4, 64, 1),
    ("dq", 80, True): (128, 128, 4, 64, 1),
    ("dq", 160, False): (64, 64, 3, 32, 0),
    ("dq", 160, True): (64, 64, 3, 32, 0),
    ("dkv", 48, False): (128, 64, 4, 64, 1),
    ("dkv", 48, True): (128, 64, 4, 64, 1),
    ("dkv", 80, False): (128, 64, 4, 64, 1),
    ("dkv", 80, True): (128, 64, 4, 64, 1),
    ("dkv", 160, False): (64, 16, 4, 32, 0),
    ("dkv", 160, True): (64, 16, 4, 32, 0),
}


def ref_span(skv: int, nref: int) -> int:
    """The kv rows of each of `nref` equal reference spans over `skv` rows:
    any span > 0 with nref * span == skv. A span need not be a multiple of
    the kernels' 64-row K/V tile: a tile that straddles two spans is masked
    column by column inside the kernels (16 and 144 tokens at the mid
    block of a 256 and a 768 px image). ValueError otherwise."""
    if nref <= 0 or skv <= 0 or skv % nref:
        raise ValueError(f"Skv={skv} does not split into {nref} equal "
                         "reference spans")
    return skv // nref


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, H*D) -> (B, H, S, D)."""
    b, s, hd = x.shape
    return x.reshape(b, s, num_heads, hd // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, H*D)."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def keep_to_mask(keep: torch.Tensor, skv: int) -> torch.Tensor:
    """(B, N) keep flags over N equal kv spans -> (B, 1, 1, Skv) bool."""
    n = keep.shape[1]
    return keep.bool().repeat_interleave(skv // n, dim=1)[:, None, None, :]


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over (B, H, S, D) with an fp32 softmax; `mask` is a
    broadcastable boolean (True = keep), and a row with no kept key gives
    0. Probabilities are cast to the input dtype before the value product
    (storygen_tpu xla_attention)."""
    dtype = q.dtype
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    if mask is not None:
        probs = probs.masked_fill(~mask, 0.0)
    return torch.matmul(probs.to(dtype).float(), v.float()).to(dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          num_heads: int, scale: float,
                          keep: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Exact softmax(q k^T * scale) v per head, fp32 softmax and fp32
    accumulation, result in q's dtype; differentiable by autograd."""
    mask = None if keep is None else keep_to_mask(keep, k.shape[1])
    out = plain_attention(split_heads(q, num_heads),
                          split_heads(k, num_heads),
                          split_heads(v, num_heads), scale, mask)
    return merge_heads(out)


def _logits(q, k, num_heads, scale, keep):
    """fp32 (B, H, Sq, Skv) logits with dropped spans at -inf, and the kept
    mask (None without `keep`)."""
    s = torch.matmul(split_heads(q, num_heads).float(),
                     split_heads(k, num_heads).float().transpose(-1, -2))
    s = s * scale
    if keep is None:
        return s, None
    mask = keep_to_mask(keep, k.shape[1])
    return s.masked_fill(~mask, float("-inf")), mask


def flash_lse_plain(q, k, num_heads: int, scale: float,
                    keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row logsumexp of the scaled logits over the kept keys, (B, H, Sq)
    fp32; -inf for a row that keeps no key."""
    s, _ = _logits(q, k, num_heads, scale, keep)
    return torch.logsumexp(s, dim=-1)


def _probs_and_ds(q, k, v, dout, lse, delta, num_heads, scale, keep):
    """P = exp(s - lse) (0 where dropped) and dS = P (dO V^T - delta),
    both rounded to q's dtype as the kernels round their operands."""
    s, mask = _logits(q, k, num_heads, scale, keep)
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    dp = torch.matmul(split_heads(dout, num_heads).float(),
                      split_heads(v, num_heads).float().transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    return p.to(q.dtype).float(), ds.to(q.dtype).float()


def flash_dq_plain(q, k, v, dout, lse, delta, num_heads: int, scale: float,
                   keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dQ = scale * dS K, (B, Sq, H*D) in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, dout, lse, delta, num_heads, scale, keep)
    dq = torch.matmul(ds, split_heads(k, num_heads).float()) * scale
    return merge_heads(dq).to(q.dtype)


def flash_dkv_plain(q, k, v, dout, lse, delta, num_heads: int, scale: float,
                    keep: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK = scale * dS^T Q and dV = P^T dO, (B, Skv, H*D) in k's dtype."""
    p, ds = _probs_and_ds(q, k, v, dout, lse, delta, num_heads, scale, keep)
    dk = torch.matmul(ds.transpose(-1, -2),
                      split_heads(q, num_heads).float()) * scale
    dv = torch.matmul(p.transpose(-1, -2),
                      split_heads(dout, num_heads).float())
    return merge_heads(dk).to(k.dtype), merge_heads(dv).to(v.dtype)


def _check(q, k, v, num_heads, keep=None):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be (B, S, H*D)")
    b, _, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != hd:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if hd % num_heads:
        raise ValueError(f"H*D={hd} is not divisible by {num_heads} heads")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share a dtype")
    if keep is not None:
        if keep.dim() != 2 or keep.shape[0] != b:
            raise ValueError(f"keep must be (B={b}, N), got "
                             f"{tuple(keep.shape)}")
        ref_span(k.shape[1], keep.shape[1])
        if keep.device != q.device:
            raise ValueError("keep must be on the device of q")


def _cuda_args(q, k, v, num_heads, keep, extra=()):
    """Validate the CUDA operands of a launch; returns (B, Sq, Skv, D, the
    launcher's (keep pointer, nref, span) arguments, the int32 keep table
    that pointer refers to)."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bfloat16, got {q.dtype}")
    b, sq, hd = q.shape
    skv = k.shape[1]
    d = hd // num_heads
    if d % 8 or (d + 15) // 16 * 16 not in _PADDED_D:
        raise ValueError(f"unsupported head dim {d}")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(extra):
        if (t.stride(2) != 1 or t.stride(1) % 8 or t.stride(0) % 8
                or t.data_ptr() % 16):
            raise ValueError(f"{name} needs a contiguous last dim and "
                             "16-byte aligned rows")
    if b * sq == 0 or skv == 0:
        raise ValueError("empty attention")
    if keep is None:
        return b, sq, skv, d, (None, 1, 1), None
    nref = keep.shape[1]
    span = ref_span(skv, nref)
    keep32 = keep.to(torch.int32).contiguous()
    return b, sq, skv, d, (keep32.data_ptr(), nref, span), keep32


def _strides(*ts):
    out = []
    for t in ts:
        out += [t.stride(0), t.stride(1)]
    return out


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def fwd_tile(d: int, masked: bool) -> Tuple[int, int, int, int, int]:
    """The instantiation that kernel F (M where `masked`) runs at head dim
    d: (BQ, BK, stages, panel columns, ping-pong) as in FWD_BUILT; its
    grid is (ceil(Sq / BQ), H, B). ValueError if none is built."""
    key = ((d + 15) // 16 * 16, bool(masked))
    if d % 8 or key not in FWD_BUILT:
        raise ValueError(f"no flash forward built for head dim {d}"
                         f"{' (masked)' if masked else ''}")
    return FWD_BUILT[key]


def v_panel(dp: int) -> int:
    """Columns of a V panel of the wgmma template at padded head dim dp:
    16 or 32, whichever divides dp (P V's N) with the wider swizzle."""
    return 32 if dp % 32 == 0 else 16


def fwd_smem_bytes(dp: int, line: tuple, v: bool = True) -> int:
    """Shared memory of one block of the F / M line `line` (a FWD_BUILT
    value), or with v=False of the L line `line` (an LSE_BUILT value), at
    padded head dim dp: csrc/flash_wgmma.cuh's FwCfg::BYTES (1 KB of
    alignment, the Q panels, STAGES K (and V) stages and the mbarriers)."""
    bq, bk, stages, a = line[:4]
    kpanels, vpw = -(-dp // a), v_panel(dp)
    q, k = kpanels * bq * 2 * a, kpanels * bk * 2 * a
    vb = dp // vpw * bk * 2 * vpw if v else 0
    return 1024 + q + stages * (k + vb) + 8 * (1 + (4 if v else 2) * stages)


def operand_map(shape, strides, num_heads: int, width: int, rows: int,
                elem: int = 2, head_stride: Optional[int] = None) -> dict:
    """The TMA tensor map that the wgmma template's launcher encodes for a
    (B, S, H*D) operand with element strides `strides` (the last 1)
    (csrc/flash_wgmma.cuh::encode_operand): the operand seen as (D, H, S,
    B), the byte strides of its dimensions 1-3, boxes of (width, 1, rows,
    1) swizzled over `elem` width bytes. Elements of `elem` bytes (2:
    bf16, 1: int8); the head stride is D elements unless `head_stride` is
    given (a one-head int8 operand gives its row stride: every stride must
    be a multiple of 16 bytes). Elements past D in dimension 0 and past S
    in dimension 2 read as zero. ValueError where TMA cannot read the
    operand or the box breaks its rules."""
    b, s, hd = shape
    d = hd // num_heads
    dims = (d, num_heads, s, b)
    hs = d if head_stride is None else head_stride
    byte_strides = (elem * hs, elem * strides[1], elem * strides[0])
    box = (width, 1, rows, 1)
    swizzle = elem * width
    if strides[2] != 1:
        raise ValueError("the head dim must be contiguous")
    if any(not 0 < x <= 2 ** 32 for x in dims):
        raise ValueError(f"tensor map dims {dims} out of range")
    if any(x % 16 or not 0 < x < 2 ** 40 for x in byte_strides):
        raise ValueError(f"tensor map strides {byte_strides} are not "
                         "positive multiples of 16 bytes")
    if (any(not 0 < x <= 256 for x in box) or swizzle not in (32, 64, 128)
            or swizzle % 16):
        raise ValueError(f"box {box} breaks TMA's rules")
    return {"dims": dims, "strides": byte_strides, "box": box,
            "swizzle": swizzle}


def fwd_maps(q, k, v, num_heads: int, line: tuple) -> dict:
    """The tensor maps of one launch of the F / M line `line` (a FWD_BUILT
    value) on q, k, v (anything with `.shape` and `.stride()`), or of the
    L line `line` (an LSE_BUILT value) where v is None: Q and K in panels
    of `line`'s panel columns, BQ and BK rows a box; V in panels of
    v_panel(dp) columns, BK rows."""
    bq, bk, _, kpw = line[:4]
    maps = {"q": operand_map(q.shape, q.stride(), num_heads, kpw, bq),
            "k": operand_map(k.shape, k.stride(), num_heads, kpw, bk)}
    if v is not None:
        dp = (q.shape[2] // num_heads + 15) // 16 * 16
        maps["v"] = operand_map(v.shape, v.stride(), num_heads, v_panel(dp),
                                bk)
    return maps


def kept_tiles(keep_row, skv: int, bk: int) -> list:
    """The K/V tiles of `bk` rows that kernel M walks for one batch row
    whose keep flags over N equal spans of the `skv` kv rows are
    `keep_row`: each tile that holds a kept row, in order (the kernels'
    next_kept; a tile across a span boundary counts if either side is
    kept)."""
    span = ref_span(skv, len(keep_row))
    out = []
    for t in range(-(-skv // bk)):
        first, last = t * bk // span, (min(t * bk + bk, skv) - 1) // span
        if any(bool(x) for x in keep_row[first:last + 1]):
            out.append(t)
    return out


def _launch_fwd(q, k, v, num_heads, scale, keep, lib=None):
    """One launch of sg_flash_fwd from `lib` (the built library if None;
    the tile study passes one built with other SG_BUILT lines)."""
    b, sq, skv, d, kargs, keep32 = _cuda_args(q, k, v, num_heads, keep)
    fwd_tile(d, keep is not None)
    if not scale > 0:
        raise ValueError(f"the forward kernel takes a scale > 0, got {scale}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = (lib or _build.load()).sg_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, num_heads, sq, skv, d, *_strides(q, k, v), *kargs, float(scale),
        _stream(q))
    _build.check(err, "sg_flash_fwd")
    return out


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              num_heads: int, scale: float) -> torch.Tensor:
    """Kernel F: unmasked forward, (B, Sq, H*D)."""
    _check(q, k, v, num_heads)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, num_heads, scale)
    out = _launch_fwd(q, k, v, num_heads, scale, None)
    flash_fwd.launches += 1
    return out


def flash_fwd_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int, scale: float,
                     keep: torch.Tensor) -> torch.Tensor:
    """Kernel M: forward over the kept reference spans only."""
    _check(q, k, v, num_heads, keep)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, num_heads, scale, keep)
    out = _launch_fwd(q, k, v, num_heads, scale, keep)
    flash_fwd_masked.launches += 1
    return out


def lse_tile(d: int, masked: bool) -> Tuple[int, int, int, int]:
    """The instantiation that kernel L runs at head dim d: (BQ, BK,
    stages, panel columns) as in LSE_BUILT; its grid is (ceil(Sq / BQ), H,
    B). ValueError if none is built."""
    key = ((d + 15) // 16 * 16, bool(masked))
    if d % 8 or key not in LSE_BUILT:
        raise ValueError(f"no flash logsumexp built for head dim {d}"
                         f"{' (masked)' if masked else ''}")
    return LSE_BUILT[key]


def _launch_lse(q, k, num_heads, scale, keep, lib=None):
    """One launch of sg_flash_lse from `lib` (the built library if None;
    the tile study passes one built with other SG_BUILT lines)."""
    b, sq, skv, d, kargs, keep32 = _cuda_args(q, k, k, num_heads, keep)
    lse_tile(d, keep is not None)
    if not scale > 0:
        raise ValueError(f"the logsumexp kernel takes a scale > 0, got "
                         f"{scale}")
    lse = torch.empty((b, num_heads, sq), dtype=torch.float32,
                      device=q.device)
    err = (lib or _build.load()).sg_flash_lse(
        q.data_ptr(), k.data_ptr(), lse.data_ptr(), b, num_heads, sq, skv,
        d, *_strides(q, k), *kargs, float(scale), _stream(q))
    _build.check(err, "sg_flash_lse")
    return lse


def flash_lse(q: torch.Tensor, k: torch.Tensor, num_heads: int,
              scale: float, keep: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """Kernel L: the forward's row logsumexp, (B, H, Sq) fp32."""
    _check(q, k, k, num_heads, keep)
    if q.device.type == "cpu":
        return flash_lse_plain(q, k, num_heads, scale, keep)
    lse = _launch_lse(q, k, num_heads, scale, keep)
    flash_lse.launches += 1
    return lse


def _check_grad_inputs(q, dout, lse, delta, num_heads):
    b, sq, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("dout must match q in shape and dtype")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, num_heads, sq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({b}, {num_heads}, {sq}) fp32")
        if t.device != q.device:
            raise ValueError(f"{name} must be on the device of q")
    if q.device.type == "cuda" and not (dout.is_contiguous()
                                        and lse.is_contiguous()
                                        and delta.is_contiguous()):
        raise ValueError("dout, lse and delta must be contiguous")


def bwd_tile(kernel: str, d: int, masked: bool
             ) -> Tuple[int, int, int, int, int]:
    """The instantiation that kernel DQ (`kernel` "dq") or DKV ("dkv") runs
    at head dim d: (BR, BC, stages, own panel columns, ping-pong) as in
    BWD_BUILT; its grid is (ceil(Sq / BR), H, B) for DQ, (ceil(Skv / BR),
    H, B) for DKV.
    ValueError if none is built."""
    key = (kernel, (d + 15) // 16 * 16, bool(masked))
    if d % 8 or key not in BWD_BUILT:
        raise ValueError(f"no flash backward {kernel} built for head dim {d}"
                         f"{' (masked)' if masked else ''}")
    return BWD_BUILT[key]


def _launch_bwd(kernel, q, k, v, dout, lse, delta, num_heads, scale, keep,
                lib=None):
    """One launch of sg_flash_dq or sg_flash_dkv from `lib` (the built
    library if None; the tile study passes one built with other SG_BUILT
    lines); returns dq, or (dk, dv)."""
    b, sq, skv, d, kargs, keep32 = _cuda_args(q, k, v, num_heads, keep,
                                              (("dout", dout),))
    bwd_tile(kernel, d, keep is not None)
    lib = lib or _build.load()
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    tail = (b, num_heads, sq, skv, d, *_strides(q, k, v), *kargs,
            float(scale), _stream(q))
    if kernel == "dq":
        out = (torch.empty(q.shape, dtype=q.dtype, device=q.device),)
        err = lib.sg_flash_dq(*ins, out[0].data_ptr(), *tail)
    else:
        dk = torch.empty((b, skv, k.shape[2]), dtype=k.dtype, device=k.device)
        out = (dk, torch.empty_like(dk))
        err = lib.sg_flash_dkv(*ins, dk.data_ptr(), out[1].data_ptr(), *tail)
    _build.check(err, f"sg_flash_{kernel}")
    return out[0] if kernel == "dq" else out


def flash_dq(q, k, v, dout, lse, delta, num_heads: int, scale: float,
             keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel DQ: dQ (B, Sq, H*D) from dout (B, Sq, H*D), lse and
    delta = rowsum(dout * out) (B, H, Sq) fp32."""
    _check(q, k, v, num_heads, keep)
    _check_grad_inputs(q, dout, lse, delta, num_heads)
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, dout, lse, delta, num_heads, scale,
                              keep)
    dq = _launch_bwd("dq", q, k, v, dout, lse, delta, num_heads, scale, keep)
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, dout, lse, delta, num_heads: int, scale: float,
              keep: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel DKV: dK, dV (B, Skv, H*D) from the inputs of `flash_dq`."""
    _check(q, k, v, num_heads, keep)
    _check_grad_inputs(q, dout, lse, delta, num_heads)
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, dout, lse, delta, num_heads, scale,
                               keep)
    dk, dv = _launch_bwd("dkv", q, k, v, dout, lse, delta, num_heads, scale,
                         keep)
    flash_dkv.launches += 1
    return dk, dv


for _w in (flash_fwd, flash_fwd_masked, flash_lse, flash_dq, flash_dkv):
    _w.launches = 0


def attention_delta(out: torch.Tensor, dout: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """delta = rowsum(dout * out) per head in fp32, (B, H, Sq)."""
    b, sq, hd = out.shape
    prod = dout.float() * out.float()
    return prod.reshape(b, sq, num_heads, hd // num_heads).sum(-1) \
        .transpose(1, 2).contiguous()


class FlashAttentionFn(torch.autograd.Function):
    """Forward F (or M with `keep`); backward delta in fp32 torch, then L,
    DQ and DKV. Saves q, k, v, the output and `keep`."""

    @staticmethod
    def forward(ctx, q, k, v, keep, num_heads: int, scale: float):
        out = (flash_fwd(q, k, v, num_heads, scale) if keep is None
               else flash_fwd_masked(q, k, v, num_heads, scale, keep))
        ctx.save_for_backward(q, k, v, out, keep)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, keep = ctx.saved_tensors
        h, scale = ctx.num_heads, ctx.scale
        dout = dout.contiguous()
        delta = attention_delta(out, dout, h)
        lse = flash_lse(q, k, h, scale, keep)
        dq = dk = dv = None
        if ctx.needs_input_grad[0]:
            dq = flash_dq(q, k, v, dout, lse, delta, h, scale, keep)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dk, dv = flash_dkv(q, k, v, dout, lse, delta, h, scale, keep)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, scale: float,
                    keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable fused attention through the kernels above (their
    plain versions for CPU tensors)."""
    return FlashAttentionFn.apply(q, k, v, keep, num_heads, scale)
