"""Can the row bound ride as a side input instead of extra q/k/v columns?

The card's counterpart of scripts/studies/bench_attn_bnd2.py: bnd2 on
kernel S2 (csrc/study_bnd2.cu) takes plain q/k/v (no host-side concats
or padding), the mean-centred bound b = q_s . mean(k) + |q_s| max_j
|k_j - mean(k)| (exp2 units) as an fp32 (B, H, Sq) side input, and sums
the unrounded p in fp32 in the kernel instead of through a ones column.

  bnd       the port's kernel F (the study's shipped forward)
  bnd2      S2 bnd2 at bq, bk in 64, 128

Usage: python -m storygen_tpu_torch.studies.bench_attn_bnd2
           [--device cpu] [--shapes attn3_L1,...] [--iters N]
"""
from __future__ import annotations

import functools

from storygen_tpu_torch.ops.study_attention import TILES, bnd2_attention
from storygen_tpu_torch.studies import common

MAIN_SHAPES = ("attn3_L1", "attn1_L1_ref", "attn1_L1_main", "attn3_L2",
               "attn1_L2_ref")


def main(device=None, shapes=MAIN_SHAPES, iters: int = 10) -> None:
    dev, card = common.setup(device)
    for name, b, h, sq, skv, d in common.shapes(shapes):
        q, k, v = common.qkv(dev, b, h, sq, skv, d)
        sm = d ** -0.5
        ref = common.xla_attn(q.float(), k.float(), v.float(), sm)
        cands = [("bnd", functools.partial(common.repo_attn, q, k, v, sm),
                  True)]
        cands += [(f"bnd2 bq{bq} bk{bk}", functools.partial(
            bnd2_attention, q, k, v, sm_scale=sm, bq=bq, bk=bk), True)
            for bq in TILES for bk in TILES]
        common.run_candidates(name, cands, ref, 4.0 * b * h * sq * skv * d,
                              dev, card, iters)


if __name__ == "__main__":
    main(**common.cli_kwargs(common.arg_parser(__doc__).parse_args()))
