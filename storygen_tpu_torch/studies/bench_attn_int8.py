"""Does an int8 q k^T pay for the d = 40 attention on the card?

The card's counterpart of scripts/studies/bench_attn_int8.py. The H100's
int8 tensor cores run at 1,979 TOPS dense, twice their 989 TFLOP/s in
bf16. At the two dominant d = 40 shapes it prints

  - the accuracy of the whole int8 pipeline (full_int8) and of bf16
    attention against the fp32 reference: max error, and the int8 mean
    relative error;
  - qk bf16 / qk int8: the bare q k^T with a kv sum (kernel S3,
    csrc/study_qk.cu, wgmma fed by TMA; q pre-transposed to (BH, D, Sq)
    as in the study), in TFLOP/s and TOP/s;
  - full int8 (quant in the call): per-row absmax quantisation of q and k
    on the host, then kernel S4 (csrc/study_int8.cu, wgmma fed by TMA):
    int8 q k^T, rank-1 dequant, bound shift, exp2, bf16 P V and the row
    sum of the rounded p,

each at bq, bk in 64, 128.

Usage: python -m storygen_tpu_torch.studies.bench_attn_int8
           [--device cpu] [--shapes attn3_L1,...] [--iters N]
"""
from __future__ import annotations

import functools

import torch

from storygen_tpu_torch.ops.study_attention import TILES
from storygen_tpu_torch.ops.study_int8 import full_int8, int8_rows, qk_only
from storygen_tpu_torch.studies import common

MAIN_SHAPES = ("attn3_L1", "attn1_L1_ref")


def int8_study_inputs(q, k):
    """The study's qk inputs: bf16 q_t (BH, D, Sq), k (BH, Skv, D), and
    int8 copies clip(round(32 x), -127, 127), the int8 k at the kernel's
    row pitch (int8_rows: 48 bytes at d 40, which TMA reads as it is), so
    that the timed call copies nothing."""
    b, h, sq, d = q.shape
    q_t = q.reshape(b * h, sq, d).transpose(1, 2).contiguous()
    kf = k.reshape(b * h, k.shape[2], d).contiguous()

    def i8(x):
        return torch.clamp(torch.round(x.float() * 32), -127, 127).to(
            torch.int8)

    return q_t, kf, i8(q_t), int8_rows(i8(kf))


def main(device=None, shapes=MAIN_SHAPES, iters: int = 10) -> None:
    dev, card = common.setup(device)
    for name, b, h, sq, skv, d in common.shapes(shapes):
        q, k, v = common.qkv(dev, b, h, sq, skv, d)
        sm = d ** -0.5
        qk_ops = 2.0 * b * h * sq * skv * d
        print(f"== {name} b{b} h{h} {sq}x{skv} d{d} (qk {qk_ops / 1e12:.2f} "
              f"TFLOP) ==", flush=True)
        with torch.no_grad():
            ref = common.xla_attn(q.float(), k.float(), v.float(), sm)
            bf = common.xla_attn(q, k, v, sm).float()
            i8 = full_int8(q, k, v, sm_scale=sm, bq=64, bk=64).float()
            rel = ((i8 - ref).abs().mean() / ref.abs().mean()).item()
            print(f"  maxerr vs fp32: bf16 {common.max_err(bf, ref):.4g}  "
                  f"int8 {common.max_err(i8, ref):.4g}  (int8 mean-rel "
                  f"{rel:.4g})  [{card}]", flush=True)
            del bf, i8
        q_t, kf, q_t8, k8 = int8_study_inputs(q, k)
        for bq in TILES:
            for bk in TILES:
                tag = f"bq{bq} bk{bk}"
                common.run_candidates(name, [
                    (f"qk bf16 {tag}", functools.partial(
                        qk_only, q_t, kf, bq=bq, bk=bk, int8=False), False)],
                    None, qk_ops, dev, card, iters)
                common.run_candidates(name, [
                    (f"qk int8 {tag}", functools.partial(
                        qk_only, q_t8, k8, bq=bq, bk=bk, int8=True), False)],
                    None, qk_ops, dev, card, iters, unit="TOP/s")
                common.run_candidates(name, [
                    (f"full int8 {tag}", functools.partial(
                        full_int8, q, k, v, sm_scale=sm, bq=bq, bk=bk),
                     True)], ref, 2 * qk_ops, dev, card, iters)


if __name__ == "__main__":
    main(**common.cli_kwargs(common.arg_parser(__doc__).parse_args()))
