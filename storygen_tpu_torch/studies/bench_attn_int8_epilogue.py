"""The attention bucket with q/k quantised after their projections: bf16
against int8, on the card.

The card's counterpart of scripts/studies/bench_attn_int8_epilogue.py. At
the sampler's two dominant d = 40 shapes it times, per call,

  bf16 path  q = x Wq, k = c Wk (torch.matmul, bf16), then the port's
             kernel F;
  int8 path  the same projections, quant_heads (per-(row, head) absmax
             int8 over each d-wide head segment, plain PyTorch, as the
             study left it to XLA's fusion), then kernel S4
             (csrc/study_int8.cu) through int8_attn_from_quant,

and prints their ratio and each path's error against the fp32 attention
of the same projections (max, and mean relative for the int8 path).

Usage: python -m storygen_tpu_torch.studies.bench_attn_int8_epilogue
           [--device cpu] [--shapes attn3_L1,...] [--iters N]
"""
from __future__ import annotations

import torch

from storygen_tpu_torch.ops import flash_attention as fa
from storygen_tpu_torch.ops.study_int8 import int8_attn_from_quant, quant_heads
from storygen_tpu_torch.studies import common

MAIN_SHAPES = ("attn3_L1", "attn1_L1")
BQ, BK = 64, 64


def main(device=None, shapes=MAIN_SHAPES, iters: int = 10) -> None:
    dev, card = common.setup(device)
    for name, b, h, sq, skv, d in common.shapes(shapes):
        c = h * d
        g = torch.Generator(device=dev).manual_seed(0)

        def rnd(*s, scale=1.0):
            return (torch.randn(s, generator=g, device=dev) * scale).to(
                torch.bfloat16)

        x, ctx = rnd(b * sq, c), rnd(b * skv, c)
        wq, wk = rnd(c, c, scale=0.03), rnd(c, c, scale=0.03)
        v = rnd(b, h, skv, d)
        v_m = fa.merge_heads(v)
        scale = d ** -0.5

        def bf16_path():
            q = torch.matmul(x, wq).reshape(b, sq, c)
            k = torch.matmul(ctx, wk).reshape(b, skv, c)
            return fa.split_heads(fa.flash_fwd(q, k, v_m, h, scale), h)

        def heads(y, s):
            return y.reshape(b, s, h, -1).transpose(1, 2)

        def int8_path():
            q8, sqs = quant_heads(torch.matmul(x, wq), h, d)
            k8, sks = quant_heads(torch.matmul(ctx, wk), h, d)
            return int8_attn_from_quant(
                heads(q8, sq), heads(sqs, sq)[..., 0], heads(k8, skv),
                heads(sks, skv)[..., 0], v, sm_scale=scale, bq=BQ, bk=BK)

        with torch.no_grad():
            qf = heads(torch.matmul(x, wq), sq).float()
            kf = heads(torch.matmul(ctx, wk), skv).float()
            ref = common.xla_attn(qf, kf, v.float(), scale)
            got = int8_path().float()
            rel = ((got - ref).abs().mean() / ref.abs().mean()).item()
            err8 = common.max_err(got, ref)
            err16 = common.max_err(bf16_path(), ref)
            del qf, kf, got
            t16 = common.time_ms(bf16_path, dev, iters)
            t8 = common.time_ms(int8_path, dev, iters)
        ops = 2.0 * (b * sq + b * skv) * c * c + 4.0 * b * h * sq * skv * d
        print(common.line(name, "bf16 proj+F", t16, ops, card, err16),
              flush=True)
        print(common.line(name, f"int8 proj+quant+S4 bq{BQ} bk{BK}", t8, ops,
                          card, err8), flush=True)
        print(f"{name}: ratio bf16/int8 {t16 / t8:.3f}x | int8 mean-rel err "
              f"{rel * 100:.2f}%  [{card}]", flush=True)


if __name__ == "__main__":
    main(**common.cli_kwargs(common.arg_parser(__doc__).parse_args()))
