"""Which knobs of the online-softmax flash forward pay on the H100.

The card's counterpart of scripts/studies/bench_attn_variants.py, on
kernel S1 (csrc/study_online.cu) at the UNet's d = 40 shapes:

  repo          the port's kernel F (csrc/flash_fwd.cu)
  ds            the scale applied to the logits in the kernel, exp
  ds+scale      the scale folded into q on the host, exp
  ds+exp2       scale * log2(e) folded into q, exp2
  ds+exp2+split2  + each warp owns two 16-row halves, issuing the second
                half's q k^T before the first half's softmax
  ds+exp2+bk128 + 128-row K/V tiles instead of 64

("ds" keeps the study's names; dimension_semantics is a TPU knob with no
counterpart here.) `sweep` times ds+scale over the card's tile rows
(bq, bk in 64, 128) at the d = 40 and d = 80 shapes.

Usage: python -m storygen_tpu_torch.studies.bench_attn_variants [sweep]
           [--device cpu] [--shapes attn3_L1,...] [--iters N]
"""
from __future__ import annotations

import functools

from storygen_tpu_torch.ops.study_attention import TILES, variant_attention
from storygen_tpu_torch.studies import common

MAIN_SHAPES = ("attn3_L1", "attn1_L1_ref", "attn1_L1_main")
SWEEP_SHAPES = MAIN_SHAPES + ("attn3_L2", "attn1_L2_ref")
VARIANTS = (
    ("ds", dict(fold_scale=False, use_exp2=False), 64),
    ("ds+scale", dict(fold_scale=True, use_exp2=False), 64),
    ("ds+exp2", dict(fold_scale=True, use_exp2=True), 64),
    ("ds+exp2+split2", dict(fold_scale=True, use_exp2=True, split2=True), 64),
    ("ds+exp2+bk128", dict(fold_scale=True, use_exp2=True), 128),
)


def main(device=None, shapes=MAIN_SHAPES, iters: int = 10) -> None:
    dev, card = common.setup(device)
    for name, b, h, sq, skv, d in common.shapes(shapes):
        q, k, v = common.qkv(dev, b, h, sq, skv, d)
        sm = d ** -0.5
        ref = common.xla_attn(q.float(), k.float(), v.float(), sm)
        cands = [(common.REPO,
                  functools.partial(common.repo_attn, q, k, v, sm), True)]
        cands += [(label, functools.partial(
            variant_attention, q, k, v, sm_scale=sm, bq=64, bk=bk, **kw),
            True) for label, kw, bk in VARIANTS]
        common.run_candidates(name, cands, ref, 4.0 * b * h * sq * skv * d,
                              dev, card, iters)


def sweep(device=None, shapes=SWEEP_SHAPES, iters: int = 10) -> None:
    """The tile sweep at ds+scale (the JAX study's winner of main())."""
    dev, card = common.setup(device)
    for name, b, h, sq, skv, d in common.shapes(shapes):
        q, k, v = common.qkv(dev, b, h, sq, skv, d)
        sm = d ** -0.5
        ref = common.xla_attn(q.float(), k.float(), v.float(), sm)
        cands = [(f"bq={bq} bk={bk}", functools.partial(
            variant_attention, q, k, v, sm_scale=sm, bq=bq, bk=bk,
            fold_scale=True, use_exp2=False), True)
            for bq in TILES for bk in TILES]
        common.run_candidates(name, cands, ref, 4.0 * b * h * sq * skv * d,
                              dev, card, iters)


if __name__ == "__main__":
    args = common.arg_parser(__doc__, ("main", "sweep")).parse_args()
    (sweep if args.mode == "sweep" else main)(**common.cli_kwargs(args))
