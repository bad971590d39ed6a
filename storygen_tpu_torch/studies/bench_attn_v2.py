"""Online softmax with q pre-scaled on the host, exp or exp2, against the
max-free bounded forward, over the card's tile rows.

The card's counterpart of scripts/studies/bench_attn_v2.py. The TPU study
asked whether a transposed-logit kernel beats its grid kernel; the
transposed layout is a TPU workaround and is gone here, so the question
left is the one its candidates carry:

  sdpa          PyTorch's fused attention, as a yardstick only
  repo          the port's kernel F
  t             S1, scale folded into q on the host, exp
  t_exp2        S1, scale * log2(e) folded, exp2
  t_bnd         S2, max-free: logits shifted by the a-priori row bound
                b = |q_s| max_j |k_j| riding an extra q column against a
                ones column of k; the row sum rides a ones column of v

each at bq, bk in 64, 128, at the UNet's d = 40, 80 and 160 shapes.

Usage: python -m storygen_tpu_torch.studies.bench_attn_v2 [--device cpu]
           [--shapes attn3_L1,...] [--iters N]
"""
from __future__ import annotations

import functools

from storygen_tpu_torch.ops.study_attention import (TILES, t_attention,
                                                    tb_attention)
from storygen_tpu_torch.studies import common

MAIN_SHAPES = ("attn3_L1", "attn1_L1_ref", "attn1_L1_main", "attn3_L2",
               "attn1_L2_ref", "attn3_L3")


def main(device=None, shapes=MAIN_SHAPES, iters: int = 10) -> None:
    dev, card = common.setup(device)
    for name, b, h, sq, skv, d in common.shapes(shapes):
        q, k, v = common.qkv(dev, b, h, sq, skv, d)
        sm = d ** -0.5
        ref = common.xla_attn(q.float(), k.float(), v.float(), sm)
        cands = [("sdpa (yardstick)", functools.partial(common.sdpa, q, k, v,
                                                        sm), True),
                 (common.REPO,
                  functools.partial(common.repo_attn, q, k, v, sm), True)]
        for bq in TILES:
            for bk in TILES:
                tag = f"bq{bq} bk{bk}"
                kw = dict(sm_scale=sm, bq=bq, bk=bk)
                cands += [
                    (f"t {tag}", functools.partial(t_attention, q, k, v,
                                                   **kw), True),
                    (f"t_exp2 {tag}", functools.partial(
                        t_attention, q, k, v, use_exp2=True, **kw), True),
                    (f"t_bnd {tag}", functools.partial(tb_attention, q, k, v,
                                                       **kw), True)]
        common.run_candidates(name, cands, ref, 4.0 * b * h * sq * skv * d,
                              dev, card, iters)


if __name__ == "__main__":
    main(**common.cli_kwargs(common.arg_parser(__doc__).parse_args()))
