"""On-card smoke test of the PyTorch/CUDA port (`storygen_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It takes no arguments and runs seven phases, all of which must pass. The
serving and training paths run in the default conv configuration and in
the fused-conv one (`ConvKernels(fused_prologue=True, strided=True)`: every
resnet conv on kernel P with its GroupNorm + SiLU as prologue, every 3x3
stride-2 conv on kernel D):
  kernels      builds the nine CUDA kernels from storygen_tpu_torch/csrc/
               and holds each against its plain PyTorch version at the
               512 px shapes of the main paths (serving and stage-2
               training), M, L, DQ and DKV also at the mid block's
               reference spans of a 256 and a 768 px image (16 and 144
               tokens, which straddle the kernels' 64-row K/V tiles), F,
               L, DQ and DKV also at a ragged 1000 x 333 shape, C, P
               and D also at the tiles of 16- and 8-column images and C at
               the input gradient's shape, and P also against kernel C run
               on the prologue already applied, with CUDA-event times for
               the kernel, its plain version and, where one PyTorch call
               computes the same function, that call (timed only, as a
               yardstick; the port never calls it), beside the kernel's
               bound, for F, M, L, DQ, DKV, C, P and D their rate in
               TFLOP/s, for F, M, C and D their factor over SDPA or cuDNN,
               for each backward case SDPA's backward alone (its forward
               run outside the timed calls) and DQ+DKV's factor over it,
               and for G (at every feed-forward site class of serving, its
               reference pass and training) its share of its bound, its
               GB/s and the time of the unfused bf16 chain of PyTorch
               calls (a yardstick, not G's function);
  models       in each configuration: one full-width UNet image-cycle pass
               (512 px, 3 refs) and one 512 px VAE encode and decode,
               kernel path against the plain path on the card, compared
               before any clamp; and one full-width stage-2 main pass (B2,
               512 px, 3 refs under a ref mask) whose loss and attn3
               gradients are compared the same way;
  story        a 4-prompt auto-regressive `generate_story` at 512x512 with
               the full-width SD-1.5 + VLCM UNet, VAE and CLIP text encoder
               (seeded random weights and token ids), checking the frames,
               that every serving kernel ran on that path, and P and D not;
  train        one stage-2 micro-step at 256 px (batch 4, 3 refs, attn3
               spans of 16 tokens at the mid block) on the kernel path
               against the plain path; then
               `train("stage2", ...)` at 512 px, batch 4, 3 refs, bf16,
               gradient checkpointing, 2 micro-steps per optimizer step, 3
               optimizer steps on seeded synthetic batches, checking finite
               losses, that every attn3 parameter moved and nothing else
               did, that the seven kernels of the default configuration ran
               on that path, and P and D not;
  story_fused  a 2-prompt story in the fused configuration: every serving
               kernel, P and D ran;
  train_fused  1 optimizer step of 2 micro-steps in the fused
               configuration: all nine kernels ran;
  studies      the attention studies' kernels (S1-S4, csrc/study_*.cu):
               drives every ported study entry point
               (storygen_tpu_torch/studies/) at one of its own UNet shapes,
               checking that it launched each of the eleven study wrappers
               and kernel F (its baseline) and nothing else; then holds
               each wrapper's instantiations against its plain version on
               the same inputs at the studies' full-width shapes (attn3 L1,
               attn1 L1, attn3 L2, attn3 L3), with kernel, plain, library
               (SDPA, for the functions that compute attention) and bound
               times. The six earlier paths launch no study kernel.

There is no CPU branch: without a CUDA device the script exits non-zero
before printing any result. The last line is the JSON status object.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# DDIM steps per story frame: a fifth of the product's 50. Every step runs
# the same kernels at the same shapes, so fewer steps cut time, not coverage.
STORY_STEPS = 10

# Kernel outputs are bf16 (lse fp32); the oracle is the plain version in
# fp32 on the same bf16 inputs. Output rounding alone is 2^-9 relative, and
# each kernel rounds one operand to bf16 inside (P in attention and in dV,
# dS in dQ and dK, the gated product in GEGLU); 1e-2 of the largest
# reference magnitude leaves a 4-5x margin.
KERNEL_RTOL = 1e-2
# Whole-model kernel path vs plain path, both bf16 end to end: the two
# differ by bf16 rounding at every site of ~70 UNet (~30 VAE) layers; a
# wrong kernel gives O(1). Bound on the relative L2 error of the output,
# and of the stage-2 loss.
MODEL_REL_L2 = 5e-2
# The stage-2 attn3 gradients, kernel path vs plain path: the backward runs
# through as many bf16 sites again, so the bound is twice the forward's;
# it holds for the gradient of every attn3 tensor, so a wrong backward at
# any one level (d40, d80 or d160) fails it.
GRAD_REL_L2 = 1e-1

# Kernel P against kernel C on P's prologue applied beforehand: both run
# the same tap loop on the same bf16 slab, so they differ only where the
# prologue's fp32 arithmetic (expf, the division) rounds one activation to
# the neighbouring bf16 value, which moves an output by about 2^-8 of one
# tap's term; 1e-3 of the largest output magnitude bounds a few such flips.
P_VS_C_RTOL = 1e-3

# The H100 SXM's dense bf16 tensor-core rate and HBM rate (NVIDIA's data
# sheet), for each kernel's bound; int8 tensor-core work runs at twice the
# bf16 rate (1,979 TOPS dense).
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1979e12
# The int8 study's column sum: exact int32 sums per K/V tile, accumulated
# in fp32 across tiles, against the exact (float64) plain sum; at attn3 L1
# its rounding is about 1e-7 of the largest sum.
INT8_SUM_RTOL = 1e-6

# attn3's per-batch keep table over its 3 reference spans (newest last)
KEEP = [[0, 0, 1], [0, 1, 1], [1, 1, 1], [0, 0, 1]]
# a table whose first row keeps no span (never drawn in training)
NONE_KEPT = [[0, 0, 0], [0, 1, 1]]

KERNEL_META = {
    "flash_fwd": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "storygen_tpu/ops/pallas_attention.py:124"},
    "flash_fwd_masked": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "storygen_tpu/ops/pallas_attention.py:157"},
    "flash_lse": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "storygen_tpu/ops/pallas_attention.py:526"},
    "flash_dq": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "storygen_tpu/ops/pallas_attention.py:558"},
    "flash_dkv": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "storygen_tpu/ops/pallas_attention.py:593"},
    "geglu_matmul": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/geglu_matmul.cu",
        "replaces": "storygen_tpu/ops/pallas_geglu.py:50"},
    "conv3x3": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/conv3x3.cu",
        "replaces": "storygen_tpu/ops/pallas_conv.py:61"},
    # _kernel with fused=True, its pallas_call at :295 via gnconv3x3 :527
    "gnconv3x3": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/conv3x3.cu",
        "replaces": "storygen_tpu/ops/pallas_conv.py:61"},
    "downconv3x3": {
        "route": "cuda", "source": "storygen_tpu_torch/csrc/downconv3x3.cu",
        "replaces": "storygen_tpu/ops/pallas_conv.py:312"},
}
# the serving and training paths' nine kernels
PORT_KERNELS = tuple(KERNEL_META)
# the kernels whose rate the kernels phase prints, with the library call
# that their factor is taken over (None: DQ and DKV, whose sum is held
# against SDPA's backward alone)
RATED = {"flash_fwd": "SDPA", "flash_fwd_masked": "SDPA",
         "flash_lse": None, "flash_dq": None, "flash_dkv": None,
         "conv3x3": "cuDNN", "gnconv3x3": "cuDNN", "downconv3x3": "cuDNN"}
STUDY_SOURCES = {"online": "storygen_tpu_torch/csrc/study_online.cu",
                 "bounded": "storygen_tpu_torch/csrc/study_bounded.cu",
                 "qk": "storygen_tpu_torch/csrc/study_qk.cu",
                 "int8": "storygen_tpu_torch/csrc/study_int8.cu"}
# each study wrapper: its kernel's source and the Pallas kernel it replaces
for _name, _src, _line in (
        ("variant_attention", "online", "bench_attn_variants.py:40"),
        ("t_attention", "online", "bench_attn_v2.py:51"),
        ("tb_attention", "bounded", "bench_attn_v2.py:112"),
        ("bounded_attention", "bounded", "bench_attn_scan.py:110"),
        ("bounded_multi_attention", "bounded", "bench_attn_scan.py:204"),
        ("ablate_attention", "bounded", "bench_attn_ablate.py:37"),
        ("bnd2_attention", "bounded", "bench_attn_bnd2.py:31"),
        ("mh_attention", "bounded", "bench_attn_multihead.py:30"),
        ("qk_only", "qk", "bench_attn_int8.py:48"),
        ("full_int8", "int8", "bench_attn_int8.py:90"),
        # the same _full_int8_kernel, its pallas_call in the epilogue study
        ("int8_attn_from_quant", "int8", "bench_attn_int8_epilogue.py:86")):
    KERNEL_META[_name] = {"route": "cuda", "source": STUDY_SOURCES[_src],
                          "replaces": f"scripts/studies/{_line}"}
STUDY_KERNELS = tuple(k for k in KERNEL_META if k not in PORT_KERNELS)
SERVING_KERNELS = ("flash_fwd", "geglu_matmul", "conv3x3")
FUSED_KERNELS = ("gnconv3x3", "downconv3x3")
# what each path must launch (> 0); every other kernel is held to 0 (the
# study kernels on every serving and training path)
PATH_KERNELS = {
    "story": SERVING_KERNELS,
    "train": tuple(k for k in PORT_KERNELS if k not in FUSED_KERNELS),
    "story_fused": SERVING_KERNELS + FUSED_KERNELS,
    "train_fused": PORT_KERNELS,
    # the study entry points, with kernel F as their baseline
    "studies": STUDY_KERNELS + ("flash_fwd",),
}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def wrappers() -> dict:
    """Every kernel's wrapper, whose `.launches` counts its launches."""
    from storygen_tpu_torch.ops import (conv, downconv, flash_attention as fa,
                                        geglu, study_attention, study_int8)
    out = {"flash_fwd": fa.flash_fwd, "flash_fwd_masked": fa.flash_fwd_masked,
           "flash_lse": fa.flash_lse, "flash_dq": fa.flash_dq,
           "flash_dkv": fa.flash_dkv, "geglu_matmul": geglu.geglu_matmul,
           "conv3x3": conv.conv3x3, "gnconv3x3": conv.gnconv3x3,
           "downconv3x3": downconv.downconv3x3}
    for w in study_attention.WRAPPERS + study_int8.WRAPPERS:
        out[w.__name__] = w
    return out


def reset_launches() -> None:
    for w in wrappers().values():
        w.launches = 0


def read_launches() -> dict:
    return {k: w.launches for k, w in wrappers().items()}


def cuda_ms(fn, iters: int) -> float:
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float):
    """The least time for the work: (ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


class Case:
    """One kernel at one shape: the kernel call, its plain version on the
    same bf16 inputs, the fp32 oracle, an optional library call, and the
    operations and bytes the function needs (unpadded shapes, kept spans
    only, each input read once and each output written once). `twin`, if
    given, is a second reference that the kernel must match within
    P_VS_C_RTOL (kernel C on P's prologue applied beforehand).
    `backward`, for DQ and DKV, makes SDPA's backward alone on the case's
    inputs: it runs SDPA's forward once and returns the call to time.
    `unfused`, for G, is the bf16 chain of PyTorch calls without the
    kernel: timed as a yardstick, it is not G's function (it rounds the
    gated product where PyTorch does)."""

    def __init__(self, name, label, kern, plain, oracle, library, flops,
                 nbytes, twin=None, backward=None, unfused=None):
        self.name, self.label = name, label
        self.kern, self.plain, self.oracle = kern, plain, oracle
        self.library, self.flops, self.nbytes = library, flops, nbytes
        self.twin, self.backward = twin, backward
        self.unfused = unfused


def _attn_cases(dev, rnd):
    """F and M forward cases, and the L/DQ/DKV backward cases."""
    import torch
    import torch.nn.functional as F
    from storygen_tpu_torch.ops import flash_attention as fa
    from storygen_tpu_torch.ops.flash_attention import split_heads

    def sdpa_mask(keep, skv):
        return None if keep is None else fa.keep_to_mask(keep, skv)

    def kept_rows(keep, b, skv):
        if keep is None:
            return b * skv
        return int(keep.sum().item()) * (skv // keep.shape[1])

    cases = []
    fwd = [("attn1 L1", 6, 4096, 4096, 40, None),
           # the main pass's attn1 (3-row CFG batch), 5 launches per pass
           ("attn1 L1", 3, 4096, 4096, 40, None),
           ("attn3 L1", 3, 4096, 12288, 40, None),
           ("attn3 L2", 3, 1024, 3072, 80, None),
           ("attn3 L3", 3, 256, 768, 160, None),
           ("attn1 mid", 6, 64, 64, 160, None),
           ("attn2 L1", 3, 4096, 77, 40, None),
           ("ragged", 2, 1000, 333, 40, None),
           ("masked attn3 L1", 4, 4096, 12288, 40, KEEP),
           ("masked attn3 L2", 4, 1024, 3072, 80, KEEP),
           ("masked attn3 L3", 4, 256, 768, 160, KEEP),
           ("masked attn3 mid", 4, 64, 192, 160, KEEP),
           # spans that straddle the 64-row K/V tiles: the mid block at
           # 256 px (span 16) and at 768 px (span 144)
           ("masked attn3 mid 256px", 4, 16, 48, 160, KEEP),
           ("masked attn3 mid 768px", 4, 144, 432, 160, KEEP),
           # a row that keeps no ref: output 0, as the plain version's
           ("masked none kept", 2, 256, 768, 80, NONE_KEPT)]
    for label, b, sq, skv, d, table in fwd:
        q, k, v = rnd(b, sq, 8 * d), rnd(b, skv, 8 * d), rnd(b, skv, 8 * d)
        sc = d ** -0.5
        masked = table is not None
        keep = (torch.tensor(table, dtype=torch.bool, device=dev)
                if masked else None)
        rows = kept_rows(keep, b, skv)
        flops = 4.0 * 8 * sq * rows * d
        nbytes = 2.0 * 8 * d * (2 * b * sq + 2 * rows)
        mask = sdpa_mask(keep, skv)
        name = "flash_fwd_masked" if masked else "flash_fwd"
        kern = ((lambda q=q, k=k, v=v, sc=sc, keep=keep:
                 fa.flash_fwd_masked(q, k, v, 8, sc, keep)) if masked else
                (lambda q=q, k=k, v=v, sc=sc: fa.flash_fwd(q, k, v, 8, sc)))
        cases.append(Case(
            name, f"{label} B{b} {sq}x{skv} d{d}", kern,
            lambda q=q, k=k, v=v, sc=sc, keep=keep: fa.flash_attention_plain(
                q, k, v, 8, sc, keep),
            lambda q=q, k=k, v=v, sc=sc, keep=keep: fa.flash_attention_plain(
                q.float(), k.float(), v.float(), 8, sc, keep),
            lambda q=q, k=k, v=v, sc=sc, mask=mask:
                F.scaled_dot_product_attention(
                    split_heads(q, 8), split_heads(k, 8), split_heads(v, 8),
                    attn_mask=mask, scale=sc),
            flops, nbytes))

    bwd = [("attn1 L1", 4, 4096, 4096, 40, None),
           ("masked attn3 L1", 4, 4096, 12288, 40, KEEP),
           ("attn2 L1", 4, 4096, 77, 40, None),
           ("masked attn3 L3", 4, 256, 768, 160, KEEP),
           ("attn1 mid", 4, 64, 64, 160, None),
           ("masked attn3 mid 256px", 4, 16, 48, 160, KEEP),
           ("masked attn3 mid 768px", 4, 144, 432, 160, KEEP),
           ("masked none kept", 2, 256, 768, 80, NONE_KEPT),
           # Sq and Skv that no tile divides: the last Q and K/V tiles of
           # DQ and DKV are partial on both sides
           ("ragged", 2, 1000, 333, 40, None),
           ("ragged", 2, 1000, 333, 160, None)]
    for label, b, sq, skv, d, table in bwd:
        q, k, v = rnd(b, sq, 8 * d), rnd(b, skv, 8 * d), rnd(b, skv, 8 * d)
        dout = rnd(b, sq, 8 * d)
        sc = d ** -0.5
        keep = (torch.tensor(table, dtype=torch.bool, device=dev)
                if table is not None else None)
        rows = kept_rows(keep, b, skv)
        with torch.no_grad():
            out = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                           8, sc, keep).to(q.dtype)
            delta = fa.attention_delta(out, dout, 8)
            lse = fa.flash_lse_plain(q.float(), k.float(), 8, sc, keep)
        mask = sdpa_mask(keep, skv)

        def sdpa_fwd_bwd(q=q, k=k, v=v, dout=dout, sc=sc, mask=mask):
            qh, kh, vh = (split_heads(t, 8).detach().requires_grad_()
                          for t in (q, k, v))
            o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                               scale=sc)
            o.backward(split_heads(dout, 8))

        def sdpa_bwd(q=q, k=k, v=v, dout=dout, sc=sc, mask=mask):
            qh, kh, vh = (split_heads(t, 8).detach().requires_grad_()
                          for t in (q, k, v))
            o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                               scale=sc)
            g = split_heads(dout, 8)
            return lambda: torch.autograd.grad(o, (qh, kh, vh), g,
                                               retain_graph=True)

        tag = f"{label} B{b} {sq}x{skv} d{d}"
        qb, kvb = 2.0 * b * sq * 8 * d, 2.0 * rows * 8 * d  # bf16 bytes
        kv_out = 2.0 * b * skv * 8 * d  # dK or dV, every row written
        rowb = 4.0 * b * 8 * sq  # an fp32 (B, H, Sq) row of scalars
        mm = 2.0 * 8 * sq * rows * d  # one (Sq x kept Skv x D) product
        args = (q, k, v, dout, lse, delta)
        f32 = tuple(t.float() for t in (q, k, v, dout)) + (lse, delta)
        cases += [
            Case("flash_lse", tag,
                 lambda q=q, k=k, sc=sc, keep=keep: fa.flash_lse(
                     q, k, 8, sc, keep),
                 lambda q=q, k=k, sc=sc, keep=keep: fa.flash_lse_plain(
                     q, k, 8, sc, keep),
                 lambda lse=lse: lse, sdpa_fwd_bwd, mm, qb + kvb + rowb),
            Case("flash_dq", tag,
                 lambda a=args, sc=sc, keep=keep: fa.flash_dq(
                     *a, 8, sc, keep),
                 lambda a=args, sc=sc, keep=keep: fa.flash_dq_plain(
                     *a, 8, sc, keep),
                 lambda a=f32, sc=sc, keep=keep: fa.flash_dq_plain(
                     *a, 8, sc, keep),
                 sdpa_fwd_bwd, 3 * mm, 3 * qb + 2 * kvb + 2 * rowb,
                 backward=sdpa_bwd),
            Case("flash_dkv", tag,
                 lambda a=args, sc=sc, keep=keep: fa.flash_dkv(
                     *a, 8, sc, keep),
                 lambda a=args, sc=sc, keep=keep: fa.flash_dkv_plain(
                     *a, 8, sc, keep),
                 lambda a=f32, sc=sc, keep=keep: fa.flash_dkv_plain(
                     *a, 8, sc, keep),
                 sdpa_fwd_bwd, 4 * mm,
                 2 * qb + 2 * kvb + 2 * kv_out + 2 * rowb,
                 backward=sdpa_bwd)]
    return cases


def kernel_cases(dev):
    """Every kernel at the main paths' 512 px shapes."""
    import torch
    import torch.nn.functional as F
    from storygen_tpu_torch.ops import conv, geglu

    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(
            torch.bfloat16)

    cases = _attn_cases(dev, rnd)
    # every feed-forward site class: the serving main pass (3-row CFG
    # batch), its reference pass (6 rows), stage-2 training (batch 4); an
    # fp32 bias (the kernel reads either dtype as stored) and a ragged M
    # under split-K
    for label, m, n, e, bias32 in [
            ("L1 ff", 3 * 4096, 1280, 320, False),
            ("L2 ff", 3 * 1024, 2560, 640, False),
            ("L3 ff", 3 * 256, 5120, 1280, False),
            ("mid ff", 192, 5120, 1280, False),
            ("L1 ref ff", 6 * 4096, 1280, 320, False),
            ("L2 ref ff", 6 * 1024, 2560, 640, False),
            ("L1 train ff", 4 * 4096, 1280, 320, False),
            ("mid train ff", 4 * 64, 5120, 1280, False),
            ("L1 ff fp32 bias", 3 * 4096, 1280, 320, True),
            ("ragged", 1000, 5120, 1280, False)]:
        p, w = rnd(m, 2 * n), rnd(e, n, s=n ** -0.5)
        bias = rnd(e).float() if bias32 else rnd(e)
        cases.append(Case(
            "geglu_matmul", f"{label} ({m}, 2x{n})->{e}",
            lambda p=p, w=w, bias=bias: geglu.geglu_matmul(p, w, bias),
            lambda p=p, w=w, bias=bias: geglu.geglu_matmul_plain(p, w, bias),
            lambda p=p, w=w, bias=bias: geglu.geglu_matmul_plain(
                p.float(), w.float(), bias.float()),
            None, 2.0 * m * n * e,
            2.0 * (2 * m * n + e * n + m * e) + bias.element_size() * e,
            unfused=lambda p=p, w=w, bias=bias: F.linear(
                p[:, :w.shape[1]] * F.gelu(p[:, w.shape[1]:]), w,
                bias.to(p.dtype))))
    for label, b, hw, cin, cout, bias_b, res in [
            ("UNet up L1 (B,C) bias", 3, 64, 960, 320, True, False),
            ("UNet L1 residual", 3, 64, 320, 320, False, True),
            ("VAE dec 512px", 1, 512, 256, 128, False, False),
            ("VAE enc conv_in", 1, 512, 3, 128, False, False),
            ("VAE dec conv_out", 1, 512, 128, 3, False, False),
            ("UNet conv_in", 3, 64, 4, 320, False, False),
            # the tiles for 16- and 8-column images and the input gradient
            ("UNet L3", 3, 16, 1280, 1280, False, False),
            ("UNet mid", 3, 8, 1280, 1280, False, False),
            ("UNet up block 1", 3, 8, 2560, 1280, False, False),
            ("UNet up L1 input gradient", 3, 64, 320, 960, False, False)]:
        x = rnd(b, hw, hw, cin)
        w9 = rnd(9, cin, cout, s=(9 * cin) ** -0.5)
        bias = torch.randn((b, cout) if bias_b else (cout,), generator=g,
                           device=dev)
        r = rnd(b, hw, hw, cout) if res else None
        # the yardstick: cuDNN's channels_last bf16 convolution (with the
        # (Cout) bias; the per-batch bias and the residual are not in it)
        x_cl = x.permute(0, 3, 1, 2)
        w_cl = w9.reshape(3, 3, cin, cout).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        b_lib = None if bias_b else bias.to(torch.bfloat16)
        pix = b * hw * hw
        cases.append(Case(
            "conv3x3", f"{label} B{b} {hw}x{hw} {cin}->{cout}",
            lambda x=x, w9=w9, bias=bias, r=r: conv.conv3x3(x, w9, bias, r),
            lambda x=x, w9=w9, bias=bias, r=r: conv.conv3x3_plain(
                x, w9, bias, r),
            lambda x=x, w9=w9, bias=bias, r=r: conv.conv3x3_plain(
                x.float(), w9.float(), bias,
                None if r is None else r.float()),
            lambda x=x_cl, w=w_cl, bb=b_lib: F.conv2d(x, w, bb, padding=1),
            2.0 * pix * 9 * cin * cout,
            2.0 * (pix * cin + 9 * cin * cout + pix * cout * (2 if res
                                                               else 1))
            + 4.0 * bias.numel()))
    return cases + _fused_conv_cases(dev, g, rnd)


def _fused_conv_cases(dev, g, rnd):
    """P (with and without the residual, (Cout) or (B, Cout) bias) and D
    (pad 1 and the VAE's (0, 1)), each with a ragged case: a width that is
    not a multiple of the 16-column tile."""
    import torch
    import torch.nn.functional as F
    from storygen_tpu_torch.ops import conv, downconv
    cases = []
    for label, b, h, w, cin, cout, bias_b, res in [
            ("UNet L1 + residual", 3, 64, 64, 320, 320, False, True),
            ("UNet up L1 (B,C) bias", 3, 64, 64, 960, 320, True, False),
            ("VAE dec 512px + residual", 1, 512, 512, 128, 128, False, True),
            ("VAE enc 512px", 3, 512, 512, 128, 128, False, False),
            # the tiles for 16- and 8-column images
            ("UNet L3 (B,C) bias + residual", 3, 16, 16, 1280, 1280, True,
             True),
            ("UNet mid (B,C) bias + residual", 3, 8, 8, 1280, 1280, True,
             True),
            ("ragged (B,C) bias + residual", 2, 40, 24, 320, 320, True,
             True)]:
        x = rnd(b, h, w, cin)
        w9 = rnd(9, cin, cout, s=(9 * cin) ** -0.5)
        bias = torch.randn((b, cout) if bias_b else (cout,), generator=g,
                           device=dev)
        a = torch.rand((b, cin), generator=g, device=dev) + 0.5
        sh = torch.randn((b, cin), generator=g, device=dev)
        r = rnd(b, h, w, cout) if res else None
        with torch.no_grad():
            act = conv.silu_affine(x, a, sh).to(x.dtype)
        pix = b * h * w
        cases.append(Case(
            "gnconv3x3", f"{label} B{b} {h}x{w} {cin}->{cout}",
            lambda x=x, w9=w9, bias=bias, a=a, sh=sh, r=r: conv.gnconv3x3(
                x, w9, bias, a, sh, r),
            lambda x=x, w9=w9, bias=bias, a=a, sh=sh, r=r:
                conv.gnconv3x3_plain(x, w9, bias, a, sh, r),
            lambda x=x, w9=w9, bias=bias, a=a, sh=sh, r=r:
                conv.gnconv3x3_plain(x.float(), w9.float(), bias, a, sh,
                                     None if r is None else r.float()),
            None, 2.0 * pix * 9 * cin * cout,
            2.0 * (pix * cin + 9 * cin * cout + pix * cout * (2 if res
                                                               else 1))
            + 4.0 * (bias.numel() + 2 * b * cin),
            twin=lambda act=act, w9=w9, bias=bias, r=r: conv.conv3x3(
                act, w9, bias, r)))
    for label, b, h, w, cin, cout, pad in [
            ("UNet L1", 3, 64, 64, 320, 320, (1, 1, 1, 1)),
            ("VAE enc 512px", 3, 512, 512, 128, 128, (0, 1, 0, 1)),
            ("VAE enc 128px", 3, 128, 128, 512, 512, (0, 1, 0, 1)),
            # the tiles for 16- and 8-column outputs
            ("UNet L2", 3, 32, 32, 640, 640, (1, 1, 1, 1)),
            ("UNet L3", 3, 16, 16, 1280, 1280, (1, 1, 1, 1)),
            ("ragged", 2, 45, 37, 96, 160, (0, 1, 0, 1))]:
        x = rnd(b, h, w, cin)
        w9 = rnd(9, cin, cout, s=(9 * cin) ** -0.5)
        bias = torch.randn((cout,), generator=g, device=dev)
        ho, wo = downconv.out_size(h, w, pad)
        # the yardstick: cuDNN's channels_last bf16 stride-2 convolution;
        # an asymmetric pad is applied to its input beforehand
        t, bo, le, ri = pad
        x_cl = F.pad(x.permute(0, 3, 1, 2), (le, ri, t, bo)).contiguous(
            memory_format=torch.channels_last)
        w_cl = w9.reshape(3, 3, cin, cout).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        pix = b * ho * wo
        cases.append(Case(
            "downconv3x3",
            f"{label} B{b} {h}x{w}->{ho}x{wo} {cin}->{cout} pad {pad}",
            lambda x=x, w9=w9, bias=bias, pad=pad: downconv.downconv3x3(
                x, w9, bias, pad),
            lambda x=x, w9=w9, bias=bias, pad=pad:
                downconv.downconv3x3_plain(x, w9, bias, pad),
            lambda x=x, w9=w9, bias=bias, pad=pad:
                downconv.downconv3x3_plain(x.float(), w9.float(), bias, pad),
            lambda x=x_cl, w=w_cl, bb=bias.to(torch.bfloat16): F.conv2d(
                x, w, bb, stride=2),
            2.0 * pix * 9 * cin * cout,
            2.0 * (b * h * w * cin + 9 * cin * cout + pix * cout)
            + 4.0 * cout))
    return cases


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def phase_kernels(dev, card: str, results: dict) -> bool:
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ok = True
    library_ms = {}  # the backward's three kernels share one yardstick
    backward_ms = {}  # SDPA's backward alone, per backward case
    dq_ms = {}  # DQ's time per backward case, for DQ+DKV's factor
    for c in kernel_cases(dev):
        with torch.no_grad():
            outs = [o.float() for o in _as_tuple(c.kern())]
            refs = [o.float() for o in _as_tuple(c.oracle())]
            twin = None if c.twin is None else c.twin().float()
        torch.cuda.synchronize()
        twin_line, twin_err = "", None
        if twin is not None:
            twin_err = (outs[0] - twin).abs().max().item()
            twin_bd = P_VS_C_RTOL * twin.abs().max().item()
            twin_ok = twin_err <= twin_bd
            ok &= twin_ok
            twin_line = (f" vs C on the applied prologue {twin_err:.3e} "
                         f"(bound {twin_bd:.3e}) "
                         f"{'ok' if twin_ok else 'FAIL'};")
        checks = []  # (error, bound, passed) of each output
        for o, r in zip(outs, refs):
            if o.shape != r.shape:
                checks.append((float("inf"), 0.0, False))
                continue
            # equal entries agree, infinite ones too (the -inf lse of a row
            # that keeps no ref); every other entry must be finite and near
            same = o == r
            e = torch.where(same, 0.0, (o - r).abs()).max().item()
            bd = KERNEL_RTOL * r[torch.isfinite(r)].abs().max().item()
            fin = bool((torch.isfinite(o) | same).all().item())
            checks.append((e, bd, fin and e <= bd))
        del outs, refs, twin
        good = all(x[2] for x in checks)
        # report the output that is furthest from its bound
        err, bound, _ = max(checks, key=lambda x: (not x[2],
                                                   x[0] / max(x[1], 1e-30)))
        with torch.no_grad():
            ms = cuda_ms(c.kern, 10)
            plain_ms = cuda_ms(c.plain, 3)
        lib_ms = None
        if c.library is not None:
            if c.library not in library_ms:
                library_ms[c.library] = cuda_ms(c.library, 5)
            lib_ms = library_ms[c.library]
        bwd_ms = None
        if c.backward is not None:
            if c.label not in backward_ms:
                call = c.backward()
                backward_ms[c.label] = cuda_ms(call, 5)
                del call
            bwd_ms = backward_ms[c.label]
        b_ms, b_by = bound_ms(c.flops, c.nbytes)
        ok &= good
        lib = "-" if lib_ms is None else f"{lib_ms:.4f} ms"
        # the rate of F, M, L, DQ, DKV, C, P and D, and the factor of F, M, C
        # and D over SDPA or cuDNN on the same inputs; DQ+DKV's factor over
        # SDPA's backward alone on the DKV line
        rate = vs_lib = vs_bwd = None
        fwd_line = ""
        if c.name in RATED:
            rate = c.flops / ms / 1e9
            fwd_line = f"  {rate:.1f} TFLOP/s"
            if lib_ms is not None and RATED[c.name] is not None:
                vs_lib = ms / lib_ms
                fwd_line = f"  {vs_lib:.2f}x {RATED[c.name]}" + fwd_line
        if c.name == "flash_dq":
            dq_ms[c.label] = ms
        unfused_ms = None
        if c.unfused is not None:
            # G: its share of its bound, its HBM rate and the unfused chain
            with torch.no_grad():
                unfused_ms = cuda_ms(c.unfused, 10)
            fwd_line += (f"  {b_ms / ms:.1%} of bound  "
                         f"{c.nbytes / ms / 1e6:.0f} GB/s  "
                         f"unfused {unfused_ms:.4f} ms")
        if bwd_ms is not None:
            fwd_line += f"  SDPA backward {bwd_ms:.4f} ms"
            if c.name == "flash_dkv" and c.label in dq_ms:
                vs_bwd = (dq_ms[c.label] + ms) / bwd_ms
                fwd_line += f", DQ+DKV {vs_bwd:.2f}x it"
        print(f"kernel {c.name:16s} {c.label:38s} max_abs_err {err:.3e} "
              f"(bound {bound:.3e}) {'ok' if good else 'FAIL'};{twin_line}  "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library {lib}  "
              f"bound {b_ms:.4f} ms ({b_by}){fwd_line}  [{card}]", flush=True)
        r = results.setdefault(c.name, {
            "name": c.name, **KERNEL_META[c.name], "launches": 0,
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bound_by": b_by, "library_ms": None, "cases": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if twin_err is not None:
            r["max_abs_err_vs_c"] = max(r.get("max_abs_err_vs_c", 0.0),
                                        twin_err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += b_ms
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms
        r["cases"].append({"case": c.label, "max_abs_err": err,
                           "bound": bound, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": b_ms, "bound_by": b_by,
                           "library_ms": lib_ms,
                           "max_abs_err_vs_c": twin_err, "tflops": rate,
                           "vs_library": vs_lib,
                           "sdpa_backward_ms": bwd_ms,
                           "dq_dkv_vs_sdpa_backward": vs_bwd,
                           "unfused_ms": unfused_ms})
    for r in results.values():  # the bound of the kernel's summed cases
        r["bound_by"] = max(r["cases"], key=lambda x: x["bound_ms"])[
            "bound_by"]
    torch.cuda.empty_cache()
    return ok


def conv_kernels(config: str):
    """The conv configuration of a phase: "default" or "fused"."""
    from storygen_tpu_torch.configs import ConvKernels
    return {"default": ConvKernels(),
            "fused": ConvKernels(fused_prologue=True, strided=True)}[config]


def full_width_models(dev, conv=None):
    """SD-1.5 + VLCM UNet, VAE and CLIP ViT-L/14 text encoder at their
    published widths, bf16, seeded random weights; `conv`
    (configs.ConvKernels, the default one if None) picks the kernels of the
    UNet's and the VAE's convs. The weights do not depend on it."""
    import torch
    from storygen_tpu_torch.configs import (CLIPTextConfig, ConvKernels,
                                            UNetConfig, VAEConfig)
    from storygen_tpu_torch.models.clip_text import CLIPTextModel
    from storygen_tpu_torch.models.init import init_random_
    from storygen_tpu_torch.models.unet import UNet2DConditionModel
    from storygen_tpu_torch.models.vae import AutoencoderKL
    conv = conv or ConvKernels()

    def make(cls, seed, *args):
        with torch.device(dev):  # allocate on the card, skip CPU init
            module = cls(*args)
        return init_random_(module.to(torch.bfloat16), seed).eval()

    return (make(UNet2DConditionModel, 1, UNetConfig(), conv),
            make(AutoencoderKL, 2, VAEConfig(), conv),
            make(CLIPTextModel, 3, CLIPTextConfig()))


def token_ids(prompts):
    """Deterministic stand-in for the CLIP tokenizer (no tokenizer files
    ship with the repository): BOS, ids seeded by the prompt, EOS padding."""
    import zlib

    import numpy as np
    ids = np.full((len(prompts), 77), 49407, dtype=np.int64)
    for i, p in enumerate(prompts):
        n = min(len(p.split()) + 1, 75)
        rs = np.random.RandomState(zlib.crc32(p.encode()))
        ids[i, 0] = 49406
        ids[i, 1:1 + n] = rs.randint(0, 49406, n)
    return ids


def kernel_vs_plain(label: str, fn, shape, card: str) -> bool:
    """Runs `fn` on the kernel path and on the plain path, and holds the
    relative L2 error of the (unclamped) outputs under MODEL_REL_L2."""
    import torch
    from storygen_tpu_torch import ops
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_k = fn().float()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with ops.plain_path():
            out_p = fn().float()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    rel = ((out_k - out_p).norm() / out_p.norm()).item()
    finite = bool(torch.isfinite(out_k).all().item())
    ok = finite and rel <= MODEL_REL_L2 and tuple(out_k.shape) == shape
    print(f"{label}: rel L2 kernel vs plain {rel:.3e} (bound "
          f"{MODEL_REL_L2:.0e}) {'ok' if ok else 'FAIL'}; kernel path "
          f"{1e3 * (t1 - t0):.1f} ms, plain path {1e3 * (t2 - t1):.1f} ms "
          f"(first calls) [{card}]", flush=True)
    return ok


def stage2_grads_vs_plain(unet, dev, card: str, config: str) -> bool:
    """One stage-2 main pass at B2, 512 px, 3 refs under KEEP's first two
    rows, masked MSE: loss and every attn3 gradient, kernel path against
    plain path (gradient checkpointing on, as in training)."""
    import torch
    from storygen_tpu_torch import ops
    from storygen_tpu_torch.training import optim
    from storygen_tpu_torch.training.losses import downsample_mask, masked_mse
    unet.gradient_checkpointing = True
    trainable = optim.partition_params(unet, optim.STAGE_PREDICATES["stage2"])
    for p in trainable.values():
        p.data = p.data.float()
    g = torch.Generator(device=dev).manual_seed(12)
    n, b = 3, 2
    with torch.no_grad():
        refs = torch.randn((n * b, 64, 64, 4), generator=g, device=dev)
        rtext = torch.randn((n * b, 77, 768), generator=g, device=dev)
        t_ref = torch.tensor([150, 20] * n, device=dev) * torch.arange(
            n, 0, -1, device=dev).repeat_interleave(b)
        _, raw = unet(refs, t_ref, rtext)
        ctx = {k: v.reshape((n, b) + v.shape[1:]).transpose(0, 1)
               .reshape(b, n * v.shape[1], v.shape[2])
               for k, v in raw.items()}
    x = torch.randn((b, 64, 64, 4), generator=g, device=dev)
    noise = torch.randn((b, 64, 64, 4), generator=g, device=dev)
    text = torch.randn((b, 77, 768), generator=g, device=dev)
    t = torch.tensor([500, 80], device=dev)
    keep = torch.tensor(KEEP[:b], dtype=torch.bool, device=dev)
    lmask = downsample_mask((torch.rand((b, 512, 512, 1), generator=g,
                                        device=dev) > 0.8).float())
    names = list(trainable)

    def run():
        pred, _ = unet(x, t, text, ctx, keep)
        loss = masked_mse(pred, noise, lmask)
        grads = torch.autograd.grad(loss, [trainable[k] for k in names])
        return loss.detach().float(), [gr.float() for gr in grads]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_k, grads_k = run()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with ops.plain_path():
        loss_p, grads_p = run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rel_loss = (abs(loss_k - loss_p) / abs(loss_p)).item()
    per = [((a - p).norm() / p.norm()).item()
           for a, p in zip(grads_k, grads_p)]
    flat_k, flat_p = (torch.cat([x.flatten() for x in gs])
                      for gs in (grads_k, grads_p))
    rel_all = ((flat_k - flat_p).norm() / flat_p.norm()).item()
    worst = max(range(len(per)), key=per.__getitem__)
    finite = bool(torch.isfinite(flat_k).all().item()) and bool(
        torch.isfinite(loss_k).item())
    ok = (finite and rel_loss <= MODEL_REL_L2 and max(per) <= GRAD_REL_L2
          and len(names) == 16 * 5)
    print(f"[{config}] stage-2 main pass B2 512px 3 refs masked: loss kernel "
          f"{loss_k.item():.6f} plain {loss_p.item():.6f} rel "
          f"{rel_loss:.3e} (bound {MODEL_REL_L2:.0e}); {len(names)} attn3 "
          f"grads rel L2 all {rel_all:.3e}, worst {per[worst]:.3e} at "
          f"{names[worst]} (bound {GRAD_REL_L2:.0e}) "
          f"{'ok' if ok else 'FAIL'}; kernel path {1e3 * (t1 - t0):.1f} ms,"
          f" plain path {1e3 * (t2 - t1):.1f} ms (first calls) [{card}]",
          flush=True)
    return ok


def phase_models(dev, card: str) -> bool:
    """In each conv configuration: one image-cycle UNet pass (3-row CFG
    batch, 3 refs at 64x64 latents), one 512 px VAE encode and one decode,
    each on the kernel path against the plain path on the same inputs; then
    the stage-2 pass."""
    ok = True
    for config in ("default", "fused"):
        ok &= models_vs_plain(dev, card, config)
    return ok


def models_vs_plain(dev, card: str, config: str) -> bool:
    import torch
    from storygen_tpu_torch.pipeline import StoryGenSampler
    unet, vae, _ = full_width_models(dev, conv_kernels(config))
    g = torch.Generator(device=dev).manual_seed(11)
    n, b = 3, 1
    refs = torch.randn((n * 2 * b, 64, 64, 4), generator=g, device=dev)
    rtext = torch.randn((n * 2 * b, 77, 768), generator=g, device=dev)
    x = torch.randn((3 * b, 64, 64, 4), generator=g, device=dev)
    text = torch.randn((3 * b, 77, 768), generator=g, device=dev)
    t_ref = torch.tensor([48, 48, 32, 32, 16, 16], device=dev)
    image = torch.rand((1, 512, 512, 3), generator=g, device=dev)
    z = torch.randn((1, 64, 64, 4), generator=g, device=dev)
    with torch.no_grad():
        _, raw = unet(refs, t_ref, rtext)
        ctx = {k: StoryGenSampler._expand(v, n, b) for k, v in raw.items()}
    ok = kernel_vs_plain(f"[{config}] unet image cycle B3 64x64 3 refs",
                         lambda: unet(x, 481, text, ctx)[0], (3, 64, 64, 4),
                         card)
    ok &= kernel_vs_plain(f"[{config}] vae encode B1 512x512 (posterior "
                          "mean)", lambda: vae.encode(image).mean,
                          (1, 64, 64, 4), card)
    ok &= kernel_vs_plain(f"[{config}] vae decode B1 64x64 latents (before "
                          "the clamp)", lambda: vae.decode(z),
                          (1, 512, 512, 3), card)
    del vae, raw, ctx
    ok &= stage2_grads_vs_plain(unet, dev, card, config)
    del unet
    torch.cuda.empty_cache()
    return ok


PROMPTS = ("A little fox finds a glowing lantern in the snowy forest.",
           "The fox carries the lantern along a frozen river at dusk.",
           "An owl watches the fox from a pine branch under the stars.",
           "The fox and the owl share the lantern light in a warm den.")


def record_launches(results: dict, launches: dict, path: str) -> bool:
    """Keep the launches of one path's run; True if every kernel the path
    must run launched and every other kernel did not. "launches" itself is
    the fused training path's count, the one path that runs all nine
    serving and training kernels, and the studies path's for the study
    kernels."""
    for k, n in launches.items():
        r = results.setdefault(k, {"name": k, **KERNEL_META[k]})
        r.setdefault("launches_by_path", {})[path] = n
        if path == ("studies" if k in STUDY_KERNELS else "train_fused"):
            r["launches"] = n
    want = PATH_KERNELS[path]
    good = all((n > 0) == (k in want) for k, n in launches.items())
    print(f"{path}-path launches: {json.dumps(launches)} "
          f"{'ok' if good else 'FAIL'}", flush=True)
    return good


def phase_story(dev, card: str, results: dict,
                config: str = "default") -> bool:
    """The serving path: a generate_story at 512x512, DDIM, guidance 7.5 /
    image guidance 3.5, frames after the first conditioned on up to 3 refs:
    4 prompts in the default configuration, 2 in the fused one."""
    import numpy as np
    import torch
    from storygen_tpu_torch.pipeline import StoryGenPipeline
    prompts = PROMPTS if config == "default" else PROMPTS[:2]
    path = "story" if config == "default" else "story_fused"
    unet, vae, clip = full_width_models(dev, conv_kernels(config))
    pipe = StoryGenPipeline(unet, vae, clip, token_ids, device=dev)
    marks = []
    decode = pipe.sampler.decode

    def timed_decode(latents):
        img = decode(latents)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return img

    pipe.sampler.decode = timed_decode
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    frames = pipe.generate_story(list(prompts),
                                 num_inference_steps=STORY_STEPS,
                                 height=512, width=512, guidance_scale=7.5,
                                 image_guidance_scale=3.5, seed=0)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = read_launches()
    per_frame = np.diff([t0] + marks)
    ok = len(frames) == len(prompts)
    for i, f in enumerate(frames):
        good = (f.shape == (512, 512, 3) and bool(np.isfinite(f).all())
                and f.min() >= 0.0 and f.max() <= 1.0)
        ok &= good
        print(f"frame {i + 1}: shape {f.shape} range [{f.min():.3f}, "
              f"{f.max():.3f}] mean {f.mean():.3f} "
              f"{'ok' if good else 'FAIL'}")
    print(f"{path}: {len(frames)} frames 512x512, DDIM-{STORY_STEPS}, "
          f"refs up to 3, "
          f"bf16: total {total:.2f} s, per frame "
          f"{', '.join(f'{s:.2f}' for s in per_frame)} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]")
    ok &= record_launches(results, launches, path)
    del pipe, unet, vae, clip
    torch.cuda.empty_cache()
    return ok


TRAIN_BATCH, TRAIN_GA = 4, 2
# optimizer steps of the train phase in each configuration
TRAIN_STEPS = {"default": 3, "fused": 1}
# the image side of the train phase's kernel-vs-plain micro-step: its attn3
# spans at the mid block (16 tokens) straddle the flash kernels' 64-row K/V
# tiles
SMALL_SIDE = 256


def stage2_step_vs_plain(dev, card: str, side: int = SMALL_SIDE) -> bool:
    """One stage-2 micro-step at `side` px (batch 4, 3 refs under KEEP, bf16,
    gradient checkpointing) through the trainer's step function, on the
    kernel path and on the plain path from the same weights, batch and
    draws: the loss and the micro-step gradient's norm, and that the kernel
    path launched M, L, DQ and DKV (no fallback to the plain versions)."""
    import torch
    from storygen_tpu_torch import ops
    from storygen_tpu_torch.configs import TrainConfig
    from storygen_tpu_torch.data.loader import SyntheticStoryDataset, collate
    from storygen_tpu_torch.training import trainer
    logdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke_step")
    cfg = TrainConfig(logdir=logdir, train_batch_size=TRAIN_BATCH,
                      gradient_accumulation_steps=TRAIN_GA, seed=0,
                      mixed_precision="bf16", remat=True)
    bundle = trainer.build_models(cfg, dev)
    synth = SyntheticStoryDataset(TRAIN_BATCH, size=side, seed=7)
    batch = trainer.to_device(collate([synth[i] for i in range(TRAIN_BATCH)]),
                              dev)
    g = torch.Generator(device=dev).manual_seed(13)
    lat, n = (side // 8, side // 8, 4), 3

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    draws = {"posterior_noise": randn(TRAIN_BATCH, *lat),
             "noise": randn(TRAIN_BATCH, *lat),
             "t": torch.tensor([500, 80, 300, 900], device=dev),
             "ref_posterior_noise": randn(n * TRAIN_BATCH, *lat),
             "ref_noise": randn(TRAIN_BATCH, *lat),
             "ref_mask": torch.tensor(KEEP, dtype=torch.bool, device=dev)}
    # the first micro-step of an accumulation only accumulates, so each
    # path's step leaves the weights as they were
    step_k, _ = trainer.make_stage_step("stage2", cfg, bundle, dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out_k = step_k(batch, g, draws)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = read_launches()
    with ops.plain_path():
        step_p, _ = trainer.make_stage_step("stage2", cfg, bundle, dev)
        out_p = step_p(batch, g, draws)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    lk, lp = out_k["loss"].item(), out_p["loss"].item()
    nk, np_ = out_k["grad_norm"].item(), out_p["grad_norm"].item()
    rel_loss, rel_norm = abs(lk - lp) / abs(lp), abs(nk - np_) / abs(np_)
    backward = ("flash_fwd_masked", "flash_lse", "flash_dq", "flash_dkv")
    ran = all(launches[k] > 0 for k in backward)
    ok = (ran and math.isfinite(lk) and math.isfinite(nk)
          and rel_loss <= MODEL_REL_L2 and rel_norm <= GRAD_REL_L2)
    print(f"stage-2 micro-step {side}px B{TRAIN_BATCH} 3 refs (attn3 mid "
          f"span {(side // 64) ** 2}): loss kernel {lk:.6f} plain {lp:.6f} "
          f"rel {rel_loss:.3e} (bound {MODEL_REL_L2:.0e}); grad norm kernel "
          f"{nk:.6f} plain {np_:.6f} rel {rel_norm:.3e} (bound "
          f"{GRAD_REL_L2:.0e}); launches M/L/DQ/DKV "
          f"{[launches[k] for k in backward]} {'ok' if ok else 'FAIL'}; "
          f"kernel path {1e3 * (t1 - t0):.1f} ms, plain path "
          f"{1e3 * (t2 - t1):.1f} ms (first calls) [{card}]", flush=True)
    del bundle, step_k, step_p
    torch.cuda.empty_cache()
    return ok


def phase_train(dev, card: str, results: dict,
                config: str = "default") -> bool:
    """The training path: `train("stage2", ...)` through the trainer, on
    seeded synthetic StorySalon-layout batches made up front. In the default
    configuration it first holds a 256 px micro-step's kernel path against
    its plain path (`stage2_step_vs_plain`)."""
    import torch
    from storygen_tpu_torch.configs import TrainConfig
    from storygen_tpu_torch.data.loader import SyntheticStoryDataset
    from storygen_tpu_torch.training import trainer
    path = "train" if config == "default" else "train_fused"
    steps = TRAIN_STEPS[config]
    ok = stage2_step_vs_plain(dev, card) if config == "default" else True
    logdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", f"chip_smoke_{path}")
    cfg = TrainConfig(logdir=logdir, train_steps=steps,
                      train_batch_size=TRAIN_BATCH,
                      gradient_accumulation_steps=TRAIN_GA, seed=0,
                      mixed_precision="bf16", remat=True)
    synth = SyntheticStoryDataset(2 * TRAIN_BATCH, size=512, seed=5)
    dataset = [synth[i] for i in range(len(synth))]  # made before the run
    bundle = trainer.build_models(cfg, dev, conv=conv_kernels(config))
    before = {f"{m}.{n}": p.detach().clone()
              for m in ("unet", "vae", "text_encoder")
              for n, p in bundle[m].named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    state = trainer.train("stage2", cfg, dataset, device=dev,
                          models_bundle=bundle)
    torch.cuda.synchronize()
    launches = read_launches()
    after = {f"{m}.{n}": p.detach()
             for m in ("unet", "vae", "text_encoder")
             for n, p in bundle[m].named_parameters()}
    moved = {k for k in before
             if not torch.equal(after[k].float(), before[k].float())}
    attn3 = {k for k in before if k.startswith("unet.") and "attn3" in k}
    finite = all(math.isfinite(x) for x in state.losses)
    n_micro = steps * TRAIN_GA
    ok &= (finite and len(state.losses) == n_micro and moved == attn3
           and len(attn3) == 16 * 5 and state.optimizer.count == steps)
    steady = state.micro_seconds[1:]
    ms = 1e3 * sum(steady) / len(steady)
    print(f"{path} stage2: {steps} optimizer steps x {TRAIN_GA} "
          f"micro-steps, batch {TRAIN_BATCH}, 512 px, 3 refs, bf16, "
          f"gradient checkpointing; losses "
          f"{', '.join(f'{x:.4f}' for x in state.losses)}; "
          f"{len(moved & attn3)}/{len(attn3)} attn3 tensors moved, "
          f"{len(moved - attn3)} other tensors moved; "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    print(f"{path}: first micro-step {1e3 * state.micro_seconds[0]:.1f} ms,"
          f" then {ms:.1f} ms per micro-step "
          f"({', '.join(f'{1e3 * s:.1f}' for s in steady)}), "
          f"{1e3 * TRAIN_BATCH / ms:.3f} samples/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]")
    ok &= record_launches(results, launches, path)
    del state, bundle, before, after
    torch.cuda.empty_cache()
    return ok

# the study phase's full-width shapes: (B, H, Sq, Skv, d)
STUDY_SHAPES = {"attn3 L1": (3, 8, 4096, 12288, 40),
                "attn1 L1": (6, 8, 4096, 4096, 40),
                "attn3 L2": (3, 8, 1024, 3072, 80),
                "attn3 L3": (3, 8, 256, 768, 160)}


def study_path() -> None:
    """Drives every ported study entry point once, on the card, at one of
    that study's own UNet shapes, 2 timed calls per candidate."""
    from storygen_tpu_torch.studies import (bench_attn_ablate,
                                            bench_attn_bnd2, bench_attn_int8,
                                            bench_attn_int8_epilogue,
                                            bench_attn_multihead,
                                            bench_attn_scan, bench_attn_v2,
                                            bench_attn_variants)
    for run, shape in (
            (bench_attn_variants.main, "attn1_L1_main"),
            (bench_attn_v2.main, "attn3_L2"),
            (bench_attn_scan.main, "attn3_L2"),
            (bench_attn_scan.main_bounded, "attn3_L2"),
            (bench_attn_scan.main_pair, "attn3_L2"),
            (bench_attn_ablate.main, "attn1_L1_ref"),
            (bench_attn_bnd2.main, "attn3_L2"),
            (bench_attn_multihead.main, "attn3_L2"),
            (bench_attn_int8.main, "attn1_L1_ref"),
            (bench_attn_int8_epilogue.main, "attn1_L1")):
        run(shapes=[shape], iters=2)


def study_cases(dev):
    """Each study wrapper at the studies' full-width shapes, over the knobs
    its study sweeps: (Case, rtol). The oracle is the wrapper's plain
    version on the same inputs; the library call is SDPA where the function
    computes attention."""
    import torch
    from storygen_tpu_torch.ops import study_attention as sa, study_int8 as si
    from storygen_tpu_torch.studies import common
    from storygen_tpu_torch.studies.bench_attn_int8 import int8_study_inputs
    inputs = {}

    def qkv(shape):
        if shape not in inputs:
            inputs[shape] = common.qkv(dev, *STUDY_SHAPES[shape], seed=4)
        return inputs[shape]

    def tag(shape, **kw):
        b, _, sq, skv, d = STUDY_SHAPES[shape]
        return (f"{shape} B{b} {sq}x{skv} d{d} "
                + " ".join(f"{k}={v}" for k, v in kw.items()))

    cases = []
    for w, shape, kw in (
            (sa.variant_attention, "attn3 L1",
             dict(bq=64, bk=64, fold_scale=False, use_exp2=False)),
            (sa.variant_attention, "attn3 L1",
             dict(bq=128, bk=64, fold_scale=True, use_exp2=True)),
            (sa.variant_attention, "attn1 L1",
             dict(bq=128, bk=128, fold_scale=True, use_exp2=True,
                  split2=True)),
            (sa.variant_attention, "attn3 L2",
             dict(bq=128, bk=64, fold_scale=True, use_exp2=False)),
            (sa.t_attention, "attn3 L2", dict(bq=64, bk=128)),
            (sa.t_attention, "attn3 L3", dict(bq=64, bk=64, use_exp2=True)),
            (sa.tb_attention, "attn3 L1", dict(bq=128, bk=64)),
            (sa.tb_attention, "attn1 L1", dict(bq=64, bk=64)),
            (sa.tb_attention, "attn3 L2", dict(bq=64, bk=128)),
            (sa.tb_attention, "attn3 L3", dict(bq=128, bk=128)),
            (sa.bounded_attention, "attn3 L1", dict(bq=128, bk=64)),
            (sa.bounded_attention, "attn3 L2", dict(bq=64, bk=64)),
            (sa.bounded_multi_attention, "attn3 L1",
             dict(bq=128, bk=64, sub=2)),
            (sa.bounded_multi_attention, "attn3 L2",
             dict(bq=64, bk=64, sub=4)),
            (sa.ablate_attention, "attn3 L1",
             dict(bq=64, bk=64, do_exp=False, do_pv=False)),
            (sa.ablate_attention, "attn3 L1",
             dict(bq=64, bk=64, do_exp=True, do_pv=False)),
            (sa.ablate_attention, "attn3 L1",
             dict(bq=64, bk=64, do_exp=False, do_pv=True)),
            (sa.ablate_attention, "attn1 L1",
             dict(bq=128, bk=128, do_exp=True, do_pv=True, halves=2)),
            (sa.bnd2_attention, "attn3 L1", dict(bq=128, bk=64)),
            (sa.bnd2_attention, "attn3 L2", dict(bq=128, bk=128)),
            (sa.mh_attention, "attn3 L3", dict(g=2)),
            (sa.mh_attention, "attn3 L2", dict(g=4)),
            (sa.mh_attention, "attn1 L1", dict(g=8))):
        q, k, v = qkv(shape)
        b, h, sq, skv, d = STUDY_SHAPES[shape]
        sm = d ** -0.5
        n = float(b * h * sq * skv * d)
        pv = kw.get("do_pv", True)
        attention = pv and kw.get("do_exp", True)
        cases.append((Case(
            w.__name__, tag(shape, **kw),
            lambda w=w, q=q, k=k, v=v, sm=sm, kw=kw: w(q, k, v, sm_scale=sm,
                                                       **kw),
            lambda w=w, q=q, k=k, v=v, sm=sm, kw=kw: w.plain(
                q, k, v, sm_scale=sm, **kw), None,
            (lambda q=q, k=k, v=v, sm=sm: common.sdpa(q, k, v, sm))
            if attention else None,
            (4.0 if pv else 2.0) * n,
            2.0 * (2 * b * h * sq * d + 2 * b * h * skv * d)), KERNEL_RTOL))

    # int8 work counted at the bf16 rate it is equivalent to
    i8 = PEAK_FLOPS / PEAK_INT8
    q, k, v = qkv("attn3 L1")
    b, h, sq, skv, d = STUDY_SHAPES["attn3 L1"]
    n = float(b * h * sq * skv * d)
    q_t, kf, q_t8, k8 = int8_study_inputs(q, k)
    for int8, qt_, k_ in ((True, q_t8, k8), (False, q_t, kf)):
        kw = dict(bq=128, bk=64, int8=int8)
        eb = 1.0 if int8 else 2.0
        cases.append((Case(
            "qk_only", tag("attn3 L1", **kw),
            lambda a=qt_, c=k_, kw=kw: si.qk_only(a, c, **kw),
            lambda a=qt_, c=k_, kw=kw: si.qk_only.plain(a, c, **kw), None,
            None, 2.0 * n * (i8 if int8 else 1.0),
            eb * b * h * d * (sq + skv) + 4.0 * b * h * sq),
            INT8_SUM_RTOL if int8 else KERNEL_RTOL))
    for shape, kw in (("attn3 L1", dict(bq=128, bk=64)),
                      ("attn1 L1", dict(bq=64, bk=64))):
        q, k, v = qkv(shape)
        b, h, sq, skv, d = STUDY_SHAPES[shape]
        sm, n = d ** -0.5, float(b * h * sq * skv * d)
        cases.append((Case(
            "full_int8", tag(shape, **kw),
            lambda q=q, k=k, v=v, sm=sm, kw=kw: si.full_int8(
                q, k, v, sm_scale=sm, **kw),
            lambda q=q, k=k, v=v, sm=sm, kw=kw: si.full_int8.plain(
                q, k, v, sm_scale=sm, **kw), None,
            lambda q=q, k=k, v=v, sm=sm: common.sdpa(q, k, v, sm),
            2.0 * n * i8 + 2.0 * n,
            2.0 * (2 * b * h * sq * d + 2 * b * h * skv * d)), KERNEL_RTOL))
    q, k, v = qkv("attn3 L1")
    b, h, sq, skv, d = STUDY_SHAPES["attn3 L1"]
    sm, n = d ** -0.5, float(b * h * sq * skv * d)
    q8, sqr = si.quant_rows(q)
    k8, skr = si.quant_rows(k)
    args = (q8, sqr, k8, skr, v)
    kw = dict(bq=128, bk=128)
    cases.append((Case(
        "int8_attn_from_quant", tag("attn3 L1", **kw),
        lambda a=args, kw=kw: si.int8_attn_from_quant(*a, sm_scale=sm, **kw),
        lambda a=args, kw=kw: si.int8_attn_from_quant.plain(
            *a, sm_scale=sm, **kw), None,
        lambda: common.sdpa(q, k, v, sm), 2.0 * n * i8 + 2.0 * n,
        b * h * d * (sq + skv) + 4.0 * b * h * (sq + skv)
        + 2.0 * (b * h * skv * d + b * h * sq * d)), KERNEL_RTOL))
    return cases


def phase_studies(dev, card: str, results: dict) -> bool:
    """The study path's launches, then every study case: kernel against
    its plain version on the same inputs, with times."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    reset_launches()
    study_path()
    torch.cuda.synchronize()
    ok = record_launches(results, read_launches(), "studies")
    torch.cuda.empty_cache()
    library_ms = {}
    for c, rtol in study_cases(dev):
        with torch.no_grad():
            out = c.kern().float()
            ref = c.plain().float()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        bound = rtol * ref.abs().max().item()
        good = (out.shape == ref.shape and err <= bound
                and bool(torch.isfinite(out).all().item()))
        ok &= good
        del out, ref
        with torch.no_grad():
            ms = cuda_ms(c.kern, 10)
            plain_ms = cuda_ms(c.plain, 3)
            lib_ms = None
            if c.library is not None:
                key = (c.label.split(" ")[0], c.label.split(" ")[1])
                if key not in library_ms:
                    library_ms[key] = cuda_ms(c.library, 5)
                lib_ms = library_ms[key]
        b_ms, b_by = bound_ms(c.flops, c.nbytes)
        lib = "-" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"study {c.name:23s} {c.label:58s} max_abs_err {err:.3e} "
              f"(bound {bound:.3e}) {'ok' if good else 'FAIL'};  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f} ms  library {lib}  bound "
              f"{b_ms:.4f} ms ({b_by})  [{card}]", flush=True)
        r = results.setdefault(c.name, {"name": c.name, **KERNEL_META[c.name]})
        for key, val in (("max_abs_err", 0.0), ("ms", 0.0), ("plain_ms", 0.0),
                         ("bound_ms", 0.0), ("library_ms", None),
                         ("cases", [])):
            r.setdefault(key, val)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += b_ms
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms
        r["cases"].append({"case": c.label, "max_abs_err": err,
                           "bound": bound, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": b_ms, "bound_by": b_by,
                           "library_ms": lib_ms})
        r["bound_by"] = max(r["cases"], key=lambda x: x["bound_ms"])[
            "bound_by"]
    # the summed cases have a library time only if each case has one (the
    # ablated modes compute no attention)
    for name in STUDY_KERNELS:
        r = results[name]
        if any(x["library_ms"] is None for x in r["cases"]):
            r["library_ms"] = None
    torch.cuda.empty_cache()
    return ok


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    from storygen_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; nvcc: {nvcc.splitlines()[-1]}")
    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build+load: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds} s)", flush=True)

    results: dict = {}
    failed = []
    for name, phase in (
            ("kernels", lambda: phase_kernels(dev, card, results)),
            ("models", lambda: phase_models(dev, card)),
            ("story", lambda: phase_story(dev, card, results)),
            ("train", lambda: phase_train(dev, card, results)),
            ("story_fused", lambda: phase_story(dev, card, results, "fused")),
            ("train_fused", lambda: phase_train(dev, card, results, "fused")),
            ("studies", lambda: phase_studies(dev, card, results))):
        t0 = time.perf_counter()
        if not phase():
            failed.append(name)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [results[k] for k in KERNEL_META]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
