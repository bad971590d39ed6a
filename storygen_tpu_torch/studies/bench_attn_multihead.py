"""Do several heads per block help the small-sequence shapes on the card?

The card's counterpart of scripts/studies/bench_attn_multihead.py: mh on
kernel S2 (csrc/study_bnd2.cu) is bnd2 with g heads per block (64-row
Q and K/V tiles), so the grid has g times fewer blocks, each of which
walks its g heads in turn on one TMA-fed K/V ring (two warpgroups that
split each tile's kv rows at d 80 / 160, one at d 40).

  bnd(cur)  the port's kernel F
  mh g2/g4/g8

Usage: python -m storygen_tpu_torch.studies.bench_attn_multihead
           [--device cpu] [--shapes attn3_L2,...] [--iters N]
"""
from __future__ import annotations

import functools

from storygen_tpu_torch.ops.study_attention import mh_attention
from storygen_tpu_torch.studies import common

MAIN_SHAPES = ("attn3_L2", "attn1_L2_ref", "attn1_L2_main", "attn3_L3",
               "attn1_L1_main")
GROUPS = (2, 4, 8)


def main(device=None, shapes=MAIN_SHAPES, iters: int = 10) -> None:
    dev, card = common.setup(device)
    for name, b, h, sq, skv, d in common.shapes(shapes):
        q, k, v = common.qkv(dev, b, h, sq, skv, d)
        sm = d ** -0.5
        ref = common.xla_attn(q.float(), k.float(), v.float(), sm)
        cands = [("bnd(cur)", functools.partial(common.repo_attn, q, k, v,
                                                sm), True)]
        cands += [(f"mh g{g}", functools.partial(
            mh_attention, q, k, v, sm_scale=sm, g=g), True)
            for g in GROUPS]
        common.run_candidates(name, cands, ref, 4.0 * b * h * sq * skv * d,
                              dev, card, iters)


if __name__ == "__main__":
    main(**common.cli_kwargs(common.arg_parser(__doc__).parse_args()))
