"""Where the time goes inside the max-free forward on the card: an
ablation.

The card's counterpart of scripts/studies/bench_attn_ablate.py, on kernel
S2 (csrc/study_bounded.cu) at the two dominant d = 40 shapes, timing
kernels that do progressively more work per K/V tile:

  qk         s = q_ext k_ext^T only (the kv sum of s is the output, so
             nothing is discarded)
  qk_exp     + exp2(s)
  qk_pv      s and the P V product (no exp; p := s)
  full_bnd   the max-free bounded kernel (q k^T + exp2 + P V)
  full_bnd2  the same with two 16-row halves per warp whose q k^T are
             issued before either half's exp2

The deltas separate the tensor-core q k^T, the exp2 and the P V. Only the
full kernels compute attention, so only they print an error.

Usage: python -m storygen_tpu_torch.studies.bench_attn_ablate
           [--device cpu] [--shapes attn3_L1,...] [--iters N]
"""
from __future__ import annotations

import functools

from storygen_tpu_torch.ops.study_attention import ablate_attention
from storygen_tpu_torch.studies import common

MAIN_SHAPES = ("attn3_L1", "attn1_L1_ref")
# (label, do_exp, do_pv, halves, prints an error)
MODES = (("qk", False, False, 1, False), ("qk_exp", True, False, 1, False),
         ("qk_pv", False, True, 1, False), ("full_bnd", True, True, 1, True),
         ("full_bnd2", True, True, 2, True))


def main(device=None, shapes=MAIN_SHAPES, iters: int = 10) -> None:
    dev, card = common.setup(device)
    for name, b, h, sq, skv, d in common.shapes(shapes):
        q, k, v = common.qkv(dev, b, h, sq, skv, d)
        sm = d ** -0.5
        ref = common.xla_attn(q.float(), k.float(), v.float(), sm)
        cands = [(common.REPO,
                  functools.partial(common.repo_attn, q, k, v, sm), True)]
        for t in (64, 128):
            cands += [(f"{label:10s} bq{t} bk{t}", functools.partial(
                ablate_attention, q, k, v, sm_scale=sm, bq=t, bk=t,
                do_exp=de, do_pv=dp, halves=hv), err)
                for label, de, dp, hv, err in MODES]
        common.run_candidates(name, cands, ref, 4.0 * b * h * sq * skv * d,
                              dev, card, iters)


if __name__ == "__main__":
    main(**common.cli_kwargs(common.arg_parser(__doc__).parse_args()))
