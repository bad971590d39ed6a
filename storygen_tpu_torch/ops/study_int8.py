"""The int8 attention studies: wrappers of `csrc/study_qk.cu` (kernel S3)
and `csrc/study_int8.cu` (kernel S4), both on kernel F's wgmma + TMA
template (`csrc/flash_wgmma.cuh`, S4 as the INT8 kind of S2 in
`csrc/study_wgmma.cuh`), their plain PyTorch versions, and the per-row
absmax quantisation the studies run on the host.

Replaces the Pallas kernels of scripts/studies/:
  qk_only               bench_attn_int8.py _qk_kernel                S3
  full_int8             bench_attn_int8.py _full_int8_kernel         S4
  int8_attn_from_quant  bench_attn_int8_epilogue.py, the same kernel S4

`qk_only` takes the study's q_t (BH, D, Sq) and k (BH, Skv, D), int8 or
bf16, and returns (BH, 1, Sq) fp32: the kv sum of q k^T per query. The
attention functions take (B, H, S, D) and return (B, H, Sq, D) in v's
dtype. `bq` and `bk` are the card's tile rows (64 or 128). Each wrapper
launches its kernel for CUDA tensors and runs its plain version for CPU
tensors, counting launches in `<wrapper>.launches` (`<wrapper>.plain` runs
the plain version on any device); an instantiation that is not built
raises ValueError on either device. The plain versions take
the int8 product exactly (in float64, exact at these magnitudes).

TMA reads an operand whose every stride is a multiple of 16 bytes, and it
reads rows that end inside a 32-byte sector far slower (PERF.md §6, PR
23), so the kernels take int8 rows at a pitch of whole sectors,
pad32(D) bytes (64 at d 40): the quantisation writes q8 and k8 straight
into such a buffer, whose bytes past D are zero (`quant_rows(x, pitch)`),
and a wrapper copies an int8 operand that comes at another pitch
(`int8_rows`); S3 copies a bf16 k into a zero-padded one of whole-sector
rows (`padded_rows`) unless it lies so already. `qk_smem` and
`int8_smem` mirror the kernels' shared memory (FwCfg::BYTES, through
`study_attention.line_smem`) at each built line.
"""
from __future__ import annotations

from typing import Optional

import torch

from storygen_tpu_torch.ops import _build
from storygen_tpu_torch.ops.study_attention import (LOG2E, TILES,
                                                    check_tiles, cuda_stream,
                                                    kernel_wrapper,
                                                    line_smem, ones_column,
                                                    pad8, pad16, pad32,
                                                    study_line)

# The instantiations the CUDA sources build, keyed as their SG_BUILT lines,
# with each line's ring stages and K panel columns (study_line's rule; int8
# rows are one 64-byte panel): csrc/study_qk.cu's (int8, the products'
# padded depth: 64 bytes of int8 in two k32 steps, 48 bf16 in three k16
# ones, bq, bk) ...
QK_BUILT = {(i8, 64 if i8 else 48, bq, bk):
            study_line(48, bq, bk, v=False, eb=1 if i8 else 2)
            for i8 in (0, 1) for bq in TILES for bk in TILES}
# ... and csrc/study_int8.cu's (int8 row bytes in shared memory, v_ext's
# padded width, bq, bk)
INT8_BUILT = {(64, 48, bq, bk): study_line(48, bq, bk, eb=1)
              for bq in TILES for bk in TILES}


def qk_smem(i8: int, bq: int, bk: int) -> int:
    """S3's shared memory at its built line (FwCfg::BYTES): the q_t slab in
    the Q slot (bq rows of one panel) and a ring of K tiles of bk rows,
    without V."""
    stages, kpw = QK_BUILT[(i8, 64 if i8 else 48, bq, bk)]
    return line_smem(48, bq, bk, stages, kpw, v=False, eb=1 if i8 else 2)


def int8_smem(bq: int, bk: int) -> int:
    """S4's shared memory at its built line (FwCfg::BYTES): Q (bq int8
    rows of 64 bytes) and a ring of stages of bk rows of k8, v_ext and the
    kv scales."""
    stages, kpw = INT8_BUILT[(64, 48, bq, bk)]
    return line_smem(48, bq, bk, stages, kpw, eb=1)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte aligned address (TMA's)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def padded_rows(t: torch.Tensor, pitch: int) -> torch.Tensor:
    """t (..., D) with its rows `pitch` elements apart and the leading dims
    packed, 16-byte aligned: t itself where it is laid out so, else a copy
    into a zero buffer of `pitch` columns (a view of its first D)."""
    want, n = [], pitch
    for size in reversed(t.shape[:-1]):
        want.append(n)
        n *= size
    if (t.stride()[:-1] == tuple(reversed(want)) and t.stride(-1) == 1
            and t.data_ptr() % 16 == 0):
        return t
    buf = t.new_zeros((*t.shape[:-1], pitch))
    buf[..., :t.shape[-1]] = t
    return buf[..., :t.shape[-1]]


def int8_rows(t8: torch.Tensor) -> torch.Tensor:
    """An int8 (..., S, D) operand as the kernels read it: rows pad32(D)
    bytes apart (whole 32-byte sectors), the leading dims packed
    (padded_rows)."""
    return padded_rows(t8, pad32(t8.shape[-1]))


def quant_rows(x: torch.Tensor, pitch: Optional[int] = None):
    """Per-row absmax int8 over the last dim, in fp32 in the study's order:
    round(x / amax * 127) with amax = max|x| + 1e-12 (round half to even,
    as jnp.round). Returns (int8 tensor, fp32 scales amax / 127). With
    `pitch`, the int8 rows are written straight into a zero buffer of
    `pitch` bytes a row, and the first D columns of it are returned (the
    kernels' layout, int8_rows)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True) + 1e-12
    q = torch.round(xf / amax * 127.0)
    if pitch is None:
        return q.to(torch.int8), amax[..., 0] / 127.0
    d = x.shape[-1]
    buf = torch.zeros((*x.shape[:-1], pitch), dtype=torch.int8,
                      device=x.device)
    buf[..., :d].copy_(q)
    return buf[..., :d], amax[..., 0] / 127.0


def quant_heads(y: torch.Tensor, h: int, d: int):
    """(R, H*D) projection output -> int8 (R, H, D) and fp32 scales (R, H):
    quant_rows over each head's d-wide segment."""
    return quant_rows(y.reshape(y.shape[0], h, d))


# ------------------------------------------------------------------ qk_only
def _qk_k(k: torch.Tensor, int8: bool):
    """S3's k as the kernel reads it, and the width of its tensor map (W
    columns, D <= W <= the row stride): int8 at pad32(D) bytes a row
    (int8_rows), W that pitch, what a row holds past D meeting the q_t
    slab's zero rows; bf16 at pad16(D) columns (padded_rows), W that width
    where the wrapper made the zero-padded copy, else D (a caller's
    padding may hold NaNs, and 0 times a NaN is not 0)."""
    d = k.shape[-1]
    if int8:
        return int8_rows(k), pad32(d)
    kc = padded_rows(k, pad16(d))
    return kc, d if kc is k else pad16(d)


def qk_only_plain(q_t: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """sum_kv (k q_t), exact in float64, as (BH, 1, Sq) fp32."""
    s = torch.matmul(k.double(), q_t.double())  # (BH, Skv, Sq)
    return s.sum(dim=1, keepdim=True).float()


@kernel_wrapper
def qk_only(wrapper, plain, q_t: torch.Tensor, k: torch.Tensor, *, bq: int,
            bk: int, int8: bool) -> torch.Tensor:
    """S3: the bare q k^T with a kv sum, int8 x int8 -> int32 (int8) or
    bf16 -> fp32."""
    if q_t.dim() != 3 or k.dim() != 3:
        raise ValueError("q_t must be (BH, D, Sq) and k (BH, Skv, D)")
    bh, d, sq = q_t.shape
    skv = k.shape[1]
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"shape mismatch q_t {tuple(q_t.shape)} k "
                         f"{tuple(k.shape)}")
    want = torch.int8 if int8 else torch.bfloat16
    if q_t.dtype != want or k.dtype != want:
        raise ValueError(f"int8={int8} takes {want}, got {q_t.dtype}, "
                         f"{k.dtype}")
    if q_t.device != k.device:
        raise ValueError("q_t and k must be on one device")
    check_tiles(bq, bk)
    if sq % bq or skv % bk or d % 8:
        raise ValueError(f"Sq={sq} must divide by bq={bq}, Skv={skv} by "
                         f"bk={bk}, D={d} by 8")
    key = (int(int8), pad32(d) if int8 else pad16(d), bq, bk)
    if key not in QK_BUILT:
        raise ValueError(f"qk_only: instantiation {key} is not built")
    if plain or q_t.device.type == "cpu":
        return qk_only_plain(q_t, k)
    if q_t.device.type != "cuda":
        raise ValueError(f"unsupported device {q_t.device}")
    qc = _aligned(q_t)
    kc, w = _qk_k(k, int8)
    out = torch.empty((bh, 1, sq), dtype=torch.float32, device=q_t.device)
    err = _build.load().sg_study_qk(qc.data_ptr(), kc.data_ptr(),
                                    out.data_ptr(), bh, sq, skv, d, w,
                                    kc.stride(0), kc.stride(1), int(int8),
                                    bq, bk, cuda_stream(q_t))
    _build.check(err, "sg_study_qk")
    wrapper.launches += 1
    return out


# ------------------------------------------------------- int8 attention
def int8_bound(q8, sq_row, k8, sk_row) -> torch.Tensor:
    """|q_d| max_j |k_d,j| of the dequantised rows (fp32, (B, H, Sq)); sq_row
    already carries scale * log2(e)."""
    qd = q8.float() * sq_row[..., None]
    kd = k8.float() * sk_row[..., None]
    kmax = torch.sqrt((kd * kd).sum(-1)).amax(dim=2, keepdim=True)
    return torch.sqrt((qd * qd).sum(-1)) * kmax


def int8_attn_plain(q8, k8, v, sq_row, sk_row, bound) -> torch.Tensor:
    """S4's function: the exact int32 logits, dequantised and shifted in
    fp32 in the study's order, exp2, p rounded to v's dtype, its row sum
    as the denominator, guard 1.2e-38."""
    s32 = torch.matmul(q8.double(), k8.double().transpose(-1, -2)).float()
    s = s32 * sk_row[..., None, :] * sq_row[..., None] - bound[..., None]
    p = torch.exp2(s).to(v.dtype).float()
    acc = torch.matmul(p, v.float())
    return (acc / p.sum(-1, keepdim=True).clamp_min(1.2e-38)).to(v.dtype)


def _int8_attn(wrapper, plain, q8, sq_row, k8, sk_row, v, bq, bk):
    """The part common to full_int8 and int8_attn_from_quant, from the
    quantised q/k and q's scales already multiplied by scale * log2(e)."""
    if q8.dim() != 4 or k8.dim() != 4 or v.dim() != 4:
        raise ValueError("q8, k8, v must be (B, H, S, D)")
    b, h, sq, d = q8.shape
    skv = k8.shape[2]
    if (k8.shape != v.shape or k8.shape[:2] != (b, h) or k8.shape[3] != d
            or sq_row.shape != (b, h, sq) or sk_row.shape != (b, h, skv)):
        raise ValueError("shape mismatch")
    if q8.dtype != torch.int8 or k8.dtype != torch.int8:
        raise ValueError("q8 and k8 must be int8")
    check_tiles(bq, bk)
    if sq % bq or skv % bk or d % 8:
        raise ValueError(f"Sq={sq} must divide by bq={bq}, Skv={skv} by "
                         f"bk={bk}, D={d} by 8")
    key = (pad32(d), pad16(pad8(d + 1)), bq, bk)
    if key not in INT8_BUILT:
        raise ValueError(f"{wrapper.__name__}: instantiation {key} is not "
                         "built")
    bound = int8_bound(q8, sq_row, k8, sk_row)
    if plain or q8.device.type == "cpu":
        return int8_attn_plain(q8, k8, v, sq_row, sk_row, bound)
    if q8.device.type != "cuda" or v.dtype != torch.bfloat16:
        raise ValueError("the kernel takes CUDA tensors and a bfloat16 v")
    out = torch.empty((b, h, sq, d), dtype=v.dtype, device=v.device)
    # q8 / k8 at the int8 pitch, v_ext = [v, 1] (the Pallas kernel's `ve`)
    ts = [int8_rows(q8), int8_rows(k8), ones_column(v)] + [
        _aligned(t.float()) for t in (sq_row, sk_row, bound)]
    err = _build.load().sg_study_int8(
        *(t.data_ptr() for t in ts), out.data_ptr(), b * h, sq, skv, d, bq,
        bk, cuda_stream(v))
    _build.check(err, "sg_study_int8")
    wrapper.launches += 1
    return out


@kernel_wrapper
def full_int8(wrapper, plain, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, *, sm_scale: float, bq: int, bk: int
              ) -> torch.Tensor:
    """S4 with the quantisation on the host: per-row absmax int8 q and k
    (written at the kernel's pitch), q's scales times scale * log2(e)."""
    d = q.shape[-1]
    q8, sq_row = quant_rows(q, pad32(d))
    k8, sk_row = quant_rows(k, pad32(d))
    return _int8_attn(wrapper, plain, q8, sq_row * (sm_scale * LOG2E), k8,
                      sk_row, v, bq, bk)


@kernel_wrapper
def int8_attn_from_quant(wrapper, plain, q8, sq_row, k8, sk_row, v, *,
                         sm_scale: float, bq: int, bk: int) -> torch.Tensor:
    """S4 fed q and k already quantised (after the projection GEMMs), with
    their per-row scales (B, H, S)."""
    return _int8_attn(wrapper, plain, q8,
                      sq_row * (sm_scale * LOG2E), k8, sk_row, v, bq, bk)


WRAPPERS = (qk_only, full_int8, int8_attn_from_quant)
