"""The flash-forward formulations of the attention studies: wrappers of
`csrc/study_online.cu` (kernel S1) and `csrc/study_bounded.cu` /
`csrc/study_bnd2.cu` (kernel S2, `csrc/study_wgmma.cuh`), both on kernel
F's wgmma + TMA template (`csrc/flash_wgmma.cuh`), their plain PyTorch
versions, and the host preparation the studies do (scale folding, the row
bounds, the extended q/k/v); and the template's lines and tensor maps
that the int8 studies' kernels S3 and S4 (ops/study_int8.py) share.

Replaces the Pallas kernels of scripts/studies/:
  variant_attention  bench_attn_variants.py _variant_kernel      S1
  t_attention        bench_attn_v2.py _t_kernel                  S1
  tb_attention       bench_attn_v2.py _tb_kernel                 S2 (TB)
  bounded_attention  bench_attn_scan.py _bounded_kernel          S2 (BOUNDED)
  bounded_multi_attention  bench_attn_scan.py _bounded_multi_kernel
  ablate_attention   bench_attn_ablate.py _ablate_kernel         S2
  bnd2_attention     bench_attn_bnd2.py _bnd2_kernel             S2 (BND2)
  mh_attention       bench_attn_multihead.py _mh_kernel          S2 (BND2, g)

Every function takes q (B, H, Sq, D), k and v (B, H, Skv, D) and returns
(B, H, Sq, D) in q's dtype, with the study's keyword arguments; `bq` and
`bk` are the card's tile rows (64 or 128: bq / 64 consumer warpgroups,
bk the N of S = Q K^T), and each knob selects a compile-time
instantiation. A wrapper launches its kernel for CUDA tensors
(bfloat16 only) and runs its plain version for CPU tensors (any float
dtype; probabilities are rounded to v's dtype before the value product, as
on the kernel path); it counts its launches in `<wrapper>.launches`, and
`<wrapper>.plain` runs the same host preparation and the plain version on
any device (the oracle the kernel is held against on the card). An
instantiation that is not built raises ValueError on either device, naming
the shared memory it would need where that is the reason.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from storygen_tpu_torch.ops import _build
from storygen_tpu_torch.ops.flash_attention import (FWD_BUILT, operand_map,
                                                   v_panel)

LOG2E = 1.4426950408889634
TILES = (64, 128)
# shared memory a block may use on the H100, and an SM's (bytes)
SMEM_LIMIT = 232448
SM_SMEM = 233472

# S2's kinds (the Kind enum of csrc/study_wgmma.cuh), and S4's
TB, BOUNDED, QK, QK_EXP, QK_PV, BND2, INT8 = range(7)
# S1's modes: the scale in the kernel with exp, folded with exp, folded
# with exp2
SCALE_IN_KERNEL, FOLDED_EXP, FOLDED_EXP2 = range(3)
# The widest Q / K panel (columns) of a padded width: one panel at d 48
# and two at d 80, as F's lines; 32 columns at the widths F has no line
# for (96, 176: 3 and 6 panels), and at 160 as F
_PANEL = {48: 64, 80: 64, 96: 32, 160: 32, 176: 32}
# F's unmasked lines: (padded width, K/V tile rows) -> (ring stages, Q / K
# panel columns)
_F_LINES = {(dp, v[1]): (v[2], v[3]) for (dp, masked), v in FWD_BUILT.items()
            if not masked}


def pad16(w: int) -> int:
    return (w + 15) // 16 * 16


def pad8(w: int) -> int:
    return (w + 7) // 8 * 8


def pad32(w: int) -> int:
    return (w + 31) // 32 * 32


def line_smem(dp: int, bq: int, rows: int, stages: int, kpw: int,
              v: bool = True, split: int = 1, qslots: int = 1,
              eb: int = 2) -> int:
    """A block's shared memory on the wgmma template
    (csrc/flash_wgmma.cuh's FwCfg::BYTES): 1 KB of alignment, `qslots` Q
    buffers of bq rows and the ring's `stages` stages of `rows` K rows
    (and V rows), both in panels of `kpw` columns of `eb`-byte elements
    (V in v_panel(dp)), with int8 Q / K (eb 1) and V each stage's kv
    scales on a 1 KB slot of their own, the second warpgroup's O and row
    sums where two split a tile (`split`), and 8 bytes a barrier."""
    krb = eb * kpw
    kpanels = -(-dp // kpw)
    stage = (kpanels * rows * krb + (rows * 2 * dp if v else 0)
             + (1024 if eb == 1 and v else 0))
    hand = 128 * (dp // 2 + 2) * 4 if split > 1 else 0
    bars = 8 * ((2 * qslots if qslots > 1 else 1)
                + (4 if v else 2) * stages)
    return 1024 + qslots * kpanels * bq * krb + stages * stage + hand + bars


def study_line(dp: int, bq: int, rows: int, v: bool = True, split: int = 1,
               qslots: int = 1, ahead: bool = False,
               eb: int = 2) -> Optional[tuple]:
    """(ring stages, Q / K panel columns) of a study instantiation whose
    ring stage holds `rows` kv rows: F's unmasked line at (dp, rows) where
    F has one (ops/flash_attention.py FWD_BUILT) and the line walks as F
    does, else the deepest ring of at most 4 stages that fits a block's
    shared memory, at the widest panel (from _PANEL[dp] down to 16
    columns) that lets one fit; None where none does. The walks that issue
    the next tile's Q K^T before the current tile's exps (split2, and QK /
    QK_EXP on kernel L's walk: `ahead`, or no V) need K_{i+1} a step
    earlier than F's, which F's two stages would expose. Int8 Q / K (`eb`
    1: S3, S4) have no F line and one panel of 64-byte rows."""
    if (dp, rows) in _F_LINES and v and not ahead and eb == 2:
        return _F_LINES[(dp, rows)]
    for kpw in (k for k in (64, 32, 16) if k <= _PANEL[dp]
                and (eb == 2 or k == 64)):
        for stages in (4, 3, 2):
            if line_smem(dp, bq, rows, stages, kpw, v, split,
                         qslots, eb) <= SMEM_LIMIT:
                return stages, kpw
    return None


def bounded_geometry(dp: int, bq: int, bk: int, sub: int, g: int,
                     kind: int) -> dict:
    """How an S2 instantiation runs on the template
    (csrc/study_wgmma.cuh::S2Cfg): consumer warpgroups `wgm`, the kv rows
    of a ring stage `rows`, V in the ring (`v`), warpgroups that split a
    tile's kv rows (`split`), Q slots (`qslots`), and the kv rows each
    warpgroup takes of a tile (`ns`, S = Q K^T's N)."""
    split = 2 if g > 1 and dp > 48 else 1
    return {"wgm": split if g > 1 else bq // 64, "rows": sub * bk,
            "v": kind not in (QK, QK_EXP), "split": split,
            "qslots": 2 if g > 1 else 1, "ns": bk // split}


def _key_line(dp, bq, rows, **kw):
    line = study_line(dp, bq, rows, **kw)
    assert line is not None, (dp, bq, rows, kw)
    return line


def _online_keys():
    yield from ((48, bq, bk, SCALE_IN_KERNEL, 1) for bq in TILES
                for bk in TILES)
    for mode in (FOLDED_EXP, FOLDED_EXP2):
        yield from ((dp, bq, bk, mode, 1) for dp in (48, 80, 160)
                    for bq in TILES for bk in TILES)
    yield from ((48, bq, bk, FOLDED_EXP2, 2) for bq in TILES for bk in TILES)


def _bounded_keys():
    for dp, kind in ((48, TB), (96, TB), (176, TB), (48, BOUNDED),
                     (96, BOUNDED), (48, BND2), (80, BND2)):
        yield from ((dp, bq, bk, 1, 1, 1, kind) for bq in TILES
                    for bk in TILES)
    yield from ((dp, bq, 64, sub, 1, 1, BOUNDED) for dp in (48, 96)
                for bq in TILES for sub in (2, 4))
    yield from ((48, t, t, 1, 1, 1, kind) for t in TILES
                for kind in (QK, QK_EXP, QK_PV))
    yield from ((48, t, t, 1, 2, 1, TB) for t in TILES)
    yield from ((dp, 64, 64, 1, 1, g, BND2) for dp in (48, 80, 160)
                for g in (2, 4, 8))


def _bounded_line(key):
    dp, bq, bk, sub, halves, g, kind = key
    geo = bounded_geometry(dp, bq, bk, sub, g, kind)
    return _key_line(dp, bq, geo["rows"], v=geo["v"], split=geo["split"],
                     qslots=geo["qslots"], ahead=halves == 2)


# The instantiations the CUDA sources build, keyed as their SG_BUILT lines,
# with the kernel-side fields of each line (ring stages, Q / K panel
# columns; study_line's rule): (padded width, bq, bk, mode, halves) for S1
# ...
ONLINE_BUILT = {key: _key_line(key[0], key[1], key[2], ahead=key[4] == 2)
                for key in _online_keys()}
# ... and (padded width, bq, bk, sub, halves, g, kind) for S2
# (csrc/study_bounded.cu; BND2's in csrc/study_bnd2.cu).
BOUNDED_BUILT = {key: _bounded_line(key) for key in _bounded_keys()}


def online_smem(dp: int, bq: int, bk: int, halves: int = 1) -> int:
    """S1's shared memory (study_online.cu's FwCfg::BYTES): Q, and a ring
    of K and V tiles of bk rows; where no line fits, the least a line
    would need (2 stages, 16-column panels)."""
    line = study_line(dp, bq, bk, ahead=halves == 2) or (2, 16)
    return line_smem(dp, bq, bk, *line)


def bounded_smem(dp: int, bq: int, bk: int, sub: int, g: int,
                 kind: int = TB, halves: int = 1) -> int:
    """S2's shared memory (study_wgmma.cuh's FwCfg::BYTES): Q (two slots
    with g > 1), a ring of stages of sub * bk rows of K and, but for QK
    and QK_EXP, of V, and with g > 1 at d 80 / 160 the hand-over between
    the two warpgroups; where no line fits, the least a line would need."""
    geo = bounded_geometry(dp, bq, bk, sub, g, kind)
    kw = dict(v=geo["v"], split=geo["split"], qslots=geo["qslots"])
    line = study_line(dp, 64 * geo["wgm"] // geo["split"], geo["rows"],
                      ahead=halves == 2, **kw) or (2, 16)
    return line_smem(dp, 64 * geo["wgm"] // geo["split"], geo["rows"],
                     *line, **kw)


def study_maps(bh: int, sq: int, skv: int, w: int, qrows: int, rows: int,
               kpw: int, v: bool = True, eb: int = 2,
               pitch: Optional[int] = None) -> dict:
    """The tensor maps of one S1 / S2 / S4 launch on (BH, S, W) operands
    (study_online.cu's, study_wgmma.cuh's and study_int8.cu's launchers:
    F's encode_operand with H = 1): Q boxes of `qrows` rows and K boxes of
    `rows`, both `kpw` columns a panel, V boxes of v_panel(pad16(w))
    columns. Columns past W read as zero. Int8 Q / K (`eb` 1, S4) lie
    `pitch` bytes a row (a multiple of 16; their head stride is the row
    stride), K's map the whole pitch wide (what K holds past W meets Q's
    zeros), and V is then the ones-extended pad8(w + 1) columns."""
    p = w if pitch is None else pitch
    maps = {"q": operand_map((bh, sq, w), (sq * p, p, 1), 1, kpw, qrows, eb,
                             p),
            "k": operand_map((bh, skv, w if eb == 2 else p), (skv * p, p, 1),
                             1, kpw, rows, eb, p)}
    if v:
        wv = w if eb == 2 else pad8(w + 1)
        maps["v"] = operand_map((bh, skv, wv), (skv * wv, wv, 1), 1,
                                v_panel(pad16(wv)), rows)
    return maps


def _require(built, key, smem: int, name: str) -> None:
    if key in built:
        return
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name} {key}: needs {smem} bytes of shared memory "
                         f"(the H100 gives a block {SMEM_LIMIT}); not built")
    raise ValueError(f"{name}: instantiation {key} is not built")


def check_tiles(bq: int, bk: int) -> None:
    if bq not in TILES or bk not in TILES:
        raise ValueError(f"bq and bk are tile rows, one of {TILES}; got "
                         f"{bq}, {bk}")


def _check(q, k, v, bq, bk, rows_per_step=None):
    """(B, H, Sq, Skv, D) after validating shapes and tiles."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, D)")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share a dtype")
    check_tiles(bq, bk)
    skv = k.shape[2]
    step = rows_per_step or bk
    if sq % bq or skv % step:
        raise ValueError(f"Sq={sq} must divide by bq={bq} and Skv={skv} by "
                         f"{step}")
    if d % 8 or sq == 0 or skv == 0:
        raise ValueError(f"unsupported head dim {d} or empty attention")
    if q.device.type == "cuda" and q.dtype != torch.bfloat16:
        raise ValueError(f"the kernels take bfloat16, got {q.dtype}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {q.device}")
    return b, h, sq, skv, d


def cuda_stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _flat(t: torch.Tensor) -> torch.Tensor:
    b, h, s, w = t.shape
    return t.contiguous().reshape(b * h, s, w)


# ---------------------------------------------------------------- host prep
def fold_scale(q: torch.Tensor, eff: float) -> torch.Tensor:
    """q * eff in fp32, back in q's dtype (the studies' host scale fold)."""
    return (q.float() * eff).to(q.dtype)


def ext_inputs(q, k, v, sm_scale: float, exp2: bool):
    """The max-free studies' extended tensors, zero-padded to a multiple of
    8 columns: q_ext = [q * scale (* log2 e), -b] with b = |q_s| max_j |k_j|
    (fp32, then q's dtype), k_ext = [k, 1], v_ext = [v, 1]."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    w = pad8(d + 1)
    qf = q.float() * (sm_scale * (LOG2E if exp2 else 1.0))
    kf = k.float()
    kmax = torch.sqrt((kf * kf).sum(-1)).amax(dim=2, keepdim=True)
    bound = torch.sqrt((qf * qf).sum(-1)) * kmax
    q_ext = q.new_zeros((b, h, sq, w))
    q_ext[..., :d] = qf.to(q.dtype)
    q_ext[..., d] = (-bound).to(q.dtype)
    return q_ext, ones_column(k), ones_column(v)


def ones_column(x: torch.Tensor) -> torch.Tensor:
    """[x, 1] zero-padded to pad8(d + 1) columns, in x's dtype: k_ext and
    v_ext of the max-free studies (v_ext's ones column makes the value
    product's column d the row sum of the rounded p)."""
    d = x.shape[-1]
    out = x.new_zeros((*x.shape[:-1], pad8(d + 1)))
    out[..., :d] = x
    out[..., d] = 1
    return out


def centred_bound(q, k, sm_scale: float):
    """bnd2's inputs: q * scale * log2(e) in q's dtype and the mean-centred
    row bound b = q_s . mean(k) + |q_s| max_j |k_j - mean(k)| (fp32,
    (B, H, Sq), exp2 units)."""
    qf = q.float() * (sm_scale * LOG2E)
    kf = k.float()
    k_mean = kf.mean(dim=2, keepdim=True)
    rmax = torch.sqrt(((kf - k_mean) ** 2).sum(-1)).amax(dim=2, keepdim=True)
    bound = (qf * k_mean).sum(-1) + torch.sqrt((qf * qf).sum(-1)) * rmax
    return qf.to(q.dtype), bound


# ---------------------------------------------------------- plain versions
def online_plain(q, k, v, scale: Optional[float], use_exp2: bool
                 ) -> torch.Tensor:
    """S1's function: softmax with an fp32 row sum, probabilities rounded
    to v's dtype before the value product, out = acc / max(l, 1e-20).
    `scale` None: q is pre-scaled."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if scale is not None:
        s = s * scale
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s) if use_exp2 else torch.exp(s)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / p.sum(-1, keepdim=True).clamp_min(1e-20)).to(q.dtype)


def bounded_plain(q_ext, k_ext, v_ext, d: int, kind: int, guard: float
                  ) -> torch.Tensor:
    """S2 on the extended tensors: p from the pre-shifted logits (exp2,
    exp or none), the ones column of v_ext as the row sum of the rounded
    p; without the value product (QK, QK_EXP) the kv sum of p broadcast
    over d."""
    s = torch.matmul(q_ext.float(), k_ext.float().transpose(-1, -2))
    p = {TB: torch.exp2, QK_EXP: torch.exp2, BOUNDED: torch.exp}.get(
        kind, lambda x: x)(s)
    if kind in (QK, QK_EXP):
        tot = p.sum(-1, keepdim=True)
        return tot.expand(*tot.shape[:-1], d).to(q_ext.dtype)
    acc = torch.matmul(p.to(v_ext.dtype).float(), v_ext.float())
    return (acc[..., :d] / acc[..., d:d + 1].clamp_min(guard)).to(
        q_ext.dtype)


def bnd2_plain(qs, k, v, bound) -> torch.Tensor:
    """S2 with the bound as a side input: p = exp2(s - b), fp32 row sum of
    the unrounded p, out = acc / max(l, 1e-30)."""
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    p = torch.exp2(s - bound[..., None])
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(qs.dtype)


def kernel_wrapper(impl):
    """The wrapper made from `impl(wrapper, plain, *args, **kw)`: it
    launches the kernel for CUDA tensors and runs the plain version for CPU
    tensors, counting launches in `.launches`; `.plain` runs the same host
    preparation and the plain version on any device (the oracle on the
    card)."""
    @functools.wraps(impl)
    def wrapper(*args, **kw):
        return impl(wrapper, False, *args, **kw)

    def plain(*args, **kw):
        return impl(wrapper, True, *args, **kw)

    wrapper.plain = plain
    wrapper.launches = 0
    return wrapper


# ---------------------------------------------------------------- launches
def _launch_online(qx, k, v, mode, bq, bk, halves, scale):
    b, h, sq, d = qx.shape
    out = torch.empty_like(qx, memory_format=torch.contiguous_format)
    qf, kf, vf = _flat(qx), _flat(k), _flat(v)
    err = _build.load().sg_study_online(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(), b * h,
        sq, k.shape[2], d, mode, bq, bk, halves, float(scale),
        cuda_stream(qx))
    _build.check(err, "sg_study_online")
    return out


def _launch_bounded(qe, ke, ve, bound, d, kind, bq, bk, sub, halves, g,
                    guard):
    b, h, sq, w = qe.shape
    out = torch.empty((b, h, sq, d), dtype=qe.dtype, device=qe.device)
    qf, kf, vf = _flat(qe), _flat(ke), _flat(ve)
    bnd = None if bound is None else bound.contiguous()
    # BND2 (one head or g a block) is study_bnd2.cu's, the rest
    # study_bounded.cu's; one C signature
    name = "sg_study_bnd2" if kind == BND2 else "sg_study_bounded"
    err = getattr(_build.load(), name)(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
        None if bnd is None else bnd.data_ptr(), out.data_ptr(), b * h, sq,
        ke.shape[2], w, d, kind, bq, bk, sub, halves, g, float(guard),
        cuda_stream(qe))
    _build.check(err, name)
    return out


def _online(wrapper, plain, q, k, v, sm_scale, bq, bk, mode, halves):
    _, _, _, _, d = _check(q, k, v, bq, bk)
    key = (pad16(d), bq, bk, mode, halves)
    _require(ONLINE_BUILT, key, online_smem(pad16(d), bq, bk, halves),
             wrapper.__name__)
    if mode == SCALE_IN_KERNEL:
        qx = q
    else:
        qx = fold_scale(q, sm_scale * (LOG2E if mode == FOLDED_EXP2 else 1.0))
    if plain or q.device.type == "cpu":
        return online_plain(qx, k, v,
                            sm_scale if mode == SCALE_IN_KERNEL else None,
                            mode == FOLDED_EXP2)
    out = _launch_online(qx, k, v, mode, bq, bk, halves, sm_scale)
    wrapper.launches += 1
    return out


@kernel_wrapper
def variant_attention(wrapper, plain, q, k, v, *, sm_scale: float,
                      bq: int, bk: int, fold_scale: bool, use_exp2: bool,
                      split2: bool = False) -> torch.Tensor:
    """S1: the online-softmax forward with the scale in the kernel
    (fold_scale False, exp only) or folded into q on the host, exp or exp2,
    and split2 (the next K/V tile's Q K^T in flight during the current
    tile's exps, in a second accumulator set of each consumer
    warpgroup)."""
    if use_exp2 and not fold_scale:
        raise ValueError("use_exp2 needs fold_scale (as in the study)")
    mode = (SCALE_IN_KERNEL if not fold_scale else
            FOLDED_EXP2 if use_exp2 else FOLDED_EXP)
    return _online(wrapper, plain, q, k, v, sm_scale, bq, bk, mode,
                   2 if split2 else 1)


@kernel_wrapper
def t_attention(wrapper, plain, q, k, v, *, sm_scale: float, bq: int,
                bk: int, use_exp2: bool = False) -> torch.Tensor:
    """S1 with q pre-scaled on the host: variant_attention(fold_scale=True)
    without the TPU's transposed output."""
    return _online(wrapper, plain, q, k, v, sm_scale, bq, bk,
                   FOLDED_EXP2 if use_exp2 else FOLDED_EXP, 1)


def _bounded(wrapper, plain, q, k, v, sm_scale, bq, bk, kind, exp2, guard,
             sub=1, halves=1):
    _, _, _, _, d = _check(q, k, v, bq, bk, bk * sub)
    dp = pad16(pad8(d + 1))
    key = (dp, bq, bk, sub, halves, 1, kind)
    _require(BOUNDED_BUILT, key,
             bounded_smem(dp, bq, bk, sub, 1, kind, halves), wrapper.__name__)
    qe, ke, ve = ext_inputs(q, k, v, sm_scale, exp2)
    if plain or q.device.type == "cpu":
        return bounded_plain(qe, ke, ve, d, kind, guard)
    out = _launch_bounded(qe, ke, ve, None, d, kind, bq, bk, sub, halves, 1,
                          guard)
    wrapper.launches += 1
    return out


@kernel_wrapper
def tb_attention(wrapper, plain, q, k, v, *, sm_scale: float, bq: int,
                 bk: int) -> torch.Tensor:
    """S2, max-free in exp2 units with the bound and the row sum riding
    extra columns of q/k/v; guard 1e-30."""
    return _bounded(wrapper, plain, q, k, v, sm_scale, bq, bk, TB, True,
                    1e-30)


@kernel_wrapper
def bounded_attention(wrapper, plain, q, k, v, *, sm_scale: float,
                      bq: int, bk: int) -> torch.Tensor:
    """S2, max-free with natural exp on scale-only logits; guard 1e-20."""
    return _bounded(wrapper, plain, q, k, v, sm_scale, bq, bk, BOUNDED,
                    False, 1e-20)


@kernel_wrapper
def bounded_multi_attention(wrapper, plain, q, k, v, *, sm_scale: float,
                            bq: int, bk: int, sub: int) -> torch.Tensor:
    """bounded_attention with `sub` independent K/V sub-tiles of bk rows per
    step (Skv must divide by bk * sub)."""
    return _bounded(wrapper, plain, q, k, v, sm_scale, bq, bk,
                    BOUNDED, False, 1e-20, sub=sub)


@kernel_wrapper
def ablate_attention(wrapper, plain, q, k, v, *, sm_scale: float,
                     bq: int, bk: int, do_exp: bool, do_pv: bool,
                     halves: int = 1) -> torch.Tensor:
    """tb_attention with parts switched off: without do_exp p is the
    shifted logit itself; without do_pv the output is the kv sum of p
    broadcast over d. With both on and halves 1 it is tb_attention's
    instantiation."""
    kind = (TB if do_exp and do_pv else QK_PV if do_pv else
            QK_EXP if do_exp else QK)
    return _bounded(wrapper, plain, q, k, v, sm_scale, bq, bk, kind, True,
                    1e-30, halves=halves)


def _bnd2(wrapper, plain, q, k, v, sm_scale, bq, bk, g):
    b, h, _, _, d = _check(q, k, v, bq, bk)
    if (b * h) % g:
        raise ValueError(f"B*H={b * h} does not divide into groups of {g}")
    key = (pad16(d), bq, bk, 1, 1, g, BND2)
    _require(BOUNDED_BUILT, key, bounded_smem(pad16(d), bq, bk, 1, g),
             wrapper.__name__)
    qs, bound = centred_bound(q, k, sm_scale)
    if plain or q.device.type == "cpu":
        return bnd2_plain(qs, k, v, bound)
    out = _launch_bounded(qs, k, v, bound, d, BND2, bq, bk, 1, 1, g, 1e-30)
    wrapper.launches += 1
    return out


@kernel_wrapper
def bnd2_attention(wrapper, plain, q, k, v, *, sm_scale: float,
                   bq: int = 64, bk: int = 64) -> torch.Tensor:
    """S2 with the mean-centred bound as an fp32 side input and the row sum
    taken in the kernel; guard 1e-30."""
    return _bnd2(wrapper, plain, q, k, v, sm_scale, bq, bk, 1)


@kernel_wrapper
def mh_attention(wrapper, plain, q, k, v, *, sm_scale: float, bq: int = 64,
                 bk: int = 64, g: int = 2) -> torch.Tensor:
    """bnd2_attention with g heads per block (B*H must divide by g)."""
    return _bnd2(wrapper, plain, q, k, v, sm_scale, bq, bk, g)


WRAPPERS = (variant_attention, t_attention, tb_attention, bounded_attention,
            bounded_multi_attention, ablate_attention, bnd2_attention,
            mh_attention)


def attention_flops(q: torch.Tensor, k: torch.Tensor) -> float:
    """4 B H Sq Skv D: the two products of an attention forward."""
    b, h, sq, d = q.shape
    return 4.0 * b * h * sq * k.shape[2] * d
