"""Which tile of kernels F and M, and of the backward's logsumexp L (all
csrc/flash_fwd.cu), is fastest at each padded head dim on the card.

Builds csrc/flash_fwd.cu once per candidate, each into its own library
whose only SG_BUILT lines are that candidate's, one nvcc per candidate, all
started together, under build/storygen_tpu_torch/tiles/, and prints
ptxas's registers and spills of each. An F / M candidate is (family, BQ,
BK, ring stages, a, b): family 1 is csrc/flash_wgmma.cuh's wgmma kernel
fed by TMA (BQ = 64 x consumer warpgroups, a = Q / K panel columns, b =
ping-pong of the two consumer warpgroups), family 0 the mma.sync template
(BK 64, a = 16-row halves per warp, b = 0), so that every key is timed
against the line it had before the wgmma kernel. An L candidate is (BQ,
halves, stages) of the mma.sync template. Then times each candidate, the
built kernel (the `flash_fwd` / `flash_fwd_masked` / `flash_lse`
wrappers) and, for F and M, SDPA as a yardstick on the UNet's 512 px
attention shapes of that head dim, with the max error against the fp32
plain version, and for F and M each one's device time per call replayed
from a CUDA graph of 20 calls, which decides where the host sets the
mean's pace (d 160). The rate counts the kept kv rows only.

The candidates need the card and nvcc; there is no CPU mode.

Usage: python -m storygen_tpu_torch.studies.flash_fwd_tiles
           [--shapes attn3_L1,...] [--iters N] [--kinds fwd,lse]
"""
from __future__ import annotations

import ctypes
import functools
import re
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from storygen_tpu_torch.ops import _build, flash_attention as fa
from storygen_tpu_torch.studies import common

WG, MMA = fa.WGMMA, fa.MMA
# 16-padded head dim -> F / M candidates (family, BQ, BK, stages, a, b):
# the wgmma lines, then the mma.sync lines the keys had
CANDIDATES: Dict[int, List[Tuple[int, int, int, int, int, int]]] = {
    48: [(WG, 128, 128, 2, 64, 1), (WG, 128, 128, 2, 64, 0),
         (WG, 128, 128, 3, 64, 1), (WG, 128, 64, 2, 64, 1),
         (WG, 128, 128, 2, 16, 1), (WG, 128, 64, 3, 16, 1),
         (WG, 192, 128, 2, 64, 0),
         (MMA, 64, 64, 2, 1, 0), (MMA, 64, 64, 2, 2, 0),
         (MMA, 128, 64, 2, 1, 0), (MMA, 128, 64, 2, 2, 0),
         (MMA, 64, 64, 3, 2, 0), (MMA, 128, 64, 3, 2, 0)],
    80: [(WG, 128, 128, 2, 16, 1), (WG, 128, 128, 2, 16, 0),
         (WG, 128, 128, 2, 64, 1), (WG, 128, 64, 2, 16, 1),
         (WG, 128, 64, 3, 16, 1), (WG, 128, 128, 3, 16, 1),
         (MMA, 64, 64, 2, 1, 0), (MMA, 64, 64, 2, 2, 0),
         (MMA, 128, 64, 2, 1, 0), (MMA, 128, 64, 2, 2, 0),
         (MMA, 64, 64, 3, 1, 0)],
    160: [(WG, 128, 64, 2, 32, 1), (WG, 128, 64, 2, 32, 0),
          (WG, 128, 64, 3, 32, 1), (WG, 128, 128, 2, 32, 1),
          (WG, 128, 64, 2, 16, 1), (WG, 192, 64, 2, 32, 0),
          (MMA, 64, 64, 2, 1, 0), (MMA, 128, 64, 2, 1, 0),
          (MMA, 64, 64, 3, 1, 0)],
}
# L needs half of F's ring and no O registers: 128-row blocks at every dp
LSE_CANDIDATES: Dict[int, List[Tuple[int, int, int]]] = {
    48: [(64, 1, 2), (128, 1, 2), (128, 2, 2), (128, 2, 3), (64, 1, 3)],
    80: [(64, 1, 2), (128, 1, 2), (128, 2, 2), (128, 2, 3)],
    160: [(64, 1, 2), (128, 1, 2), (128, 2, 2), (64, 1, 3)],
}
# the kernel of a candidate -> its SG_BUILT kind
KINDS = {"fwd": "kFwd", "lse": "kLse"}
SOURCE = "flash_fwd.cu"
# the UNet's attention sites at 512 px: (B, Sq, Skv, keep table or None),
# 8 heads; attn3's table as in chip_smoke.py
KEEP = [[0, 0, 1], [0, 1, 1], [1, 1, 1], [0, 0, 1]]
SHAPES = {
    "attn3_L1": (3, 4096, 12288, 40, None),
    "attn1_L1_ref": (6, 4096, 4096, 40, None),
    "attn1_L1_main": (3, 4096, 4096, 40, None),
    "attn2_L1": (3, 4096, 77, 40, None),
    "masked_attn3_L1": (4, 4096, 12288, 40, KEEP),
    "attn3_L2": (3, 1024, 3072, 80, None),
    "attn1_L2_ref": (6, 1024, 1024, 80, None),
    "masked_attn3_L2": (4, 1024, 3072, 80, KEEP),
    "attn3_L3": (3, 256, 768, 160, None),
    "masked_attn3_L3": (4, 256, 768, 160, KEEP),
    "masked_attn3_mid": (4, 64, 192, 160, KEEP),
    # the few-row sites of the mid block: its attn1, and attn3's spans of
    # a 256 and a 768 px image (16 and 144 tokens)
    "attn1_mid": (6, 64, 64, 160, None),
    "masked_attn3_mid_256px": (4, 16, 48, 160, KEEP),
    "masked_attn3_mid_768px": (4, 144, 432, 160, KEEP),
}
HEADS = 8
_BUILT_LINE = re.compile(r"^[ \t]*SG_BUILT\(k\w+,[^)]*\)[ \t]*\n", re.M)


def padded(d: int) -> int:
    return (d + 15) // 16 * 16


def label(cand) -> str:
    """A candidate's name in the study's lines."""
    if len(cand) == 3:
        bq, halves, stages = cand
        return f"L bq{bq} {halves}h {stages}s"
    fam, bq, bk, stages, a, b = cand
    if fam == WG:
        return f"wgmma {bq}/{bk} {stages}s p{a}{' pp' if b else ''}"
    return f"mma bq{bq} {a}h {stages}s"


def candidate_source(dp: int, *cand, kind: str = "fwd") -> str:
    """flash_fwd.cu with its SG_BUILT lines replaced by the candidate's two:
    kernel `kind` ("fwd" for F and M, `cand` = (family, BQ, BK, stages, a,
    b); "lse" for L, `cand` = (BQ, halves, stages)), unmasked and masked at
    16-padded head dim dp."""
    src = (_build.CSRC / SOURCE).read_text()
    first = _BUILT_LINE.search(src)
    if first is None:
        raise ValueError(f"{SOURCE} has no SG_BUILT lines")
    body = _BUILT_LINE.sub("", src)
    if kind == "fwd":
        fam, bq, bk, stages, a, b = cand
        args = [(m, fam, bq, bk, stages, a, b) for m in (0, 1)]
    else:
        bq, halves, stages = cand
        args = [(m, bq, fa._BK, halves, stages) for m in (0, 1)]
    mine = "".join(f"  SG_BUILT({KINDS[kind]}, {dp}, "
                   f"{', '.join(map(str, x))})\n" for x in args)
    return body[:first.start()] + mine + body[first.start():]


def build(cands, kind: str = "fwd") -> Dict[tuple, Path]:
    """One library per (dp, *candidate), keyed by the source's hash and the
    candidate, built in parallel, each printing its ptxas registers and
    spills."""
    root = (_build.BUILD_ROOT / "tiles"
            / _build.source_hash([_build.CSRC / SOURCE]))
    return common.build_candidates(
        root, {c: (f"flash_{kind}_{'_'.join(map(str, c))}",
                   candidate_source(*c, kind=kind)) for c in cands},
        "flash_")


def load(path: Path, kind: str = "fwd") -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, f"sg_flash_{kind}")
    fn.argtypes = list(_build.SIGNATURES[f"sg_flash_{kind}"])
    fn.restype = ctypes.c_int
    return lib


def main(device=None, shapes=tuple(SHAPES), iters: int = 10,
         kinds=("fwd", "lse")) -> None:
    dev, card = common.setup(device)
    if dev.type != "cuda":
        raise RuntimeError("the tile candidates run on the card only")
    todo = [(n, *SHAPES[n]) for n in shapes]
    dps = sorted({padded(d) for *_, d, _ in todo})
    cands = [(dp, *c) for dp in dps for c in CANDIDATES[dp]]
    lse_cands = [(dp, *c) for dp in dps for c in LSE_CANDIDATES[dp]]
    libs = ({c: load(p) for c, p in build(cands).items()}
            if "fwd" in kinds else {})
    lse_libs = ({c: load(p, "lse")
                 for c, p in build(lse_cands, "lse").items()}
                if "lse" in kinds else {})
    g = torch.Generator(device=dev).manual_seed(0)
    for name, b, sq, skv, d, table in todo:
        q, k, v = (torch.randn((b, s, HEADS * d), generator=g, device=dev)
                   .to(torch.bfloat16) for s in (sq, skv, skv))
        keep = (None if table is None else
                torch.tensor(table, dtype=torch.bool, device=dev))
        sm = d ** -0.5
        kept = b * skv if keep is None else (
            int(keep.sum().item()) * (skv // keep.shape[1]))
        label_ = f"{name} B{b} {sq}x{skv} d{d}"
        if "fwd" in kinds:
            with torch.no_grad():
                ref = fa.flash_attention_plain(q.float(), k.float(),
                                               v.float(), HEADS, sm, keep)
            mask = None if keep is None else fa.keep_to_mask(keep, skv)
            built = fa.fwd_tile(d, keep is not None)
            here = [
                ("sdpa (yardstick)", lambda: fa.merge_heads(common.sdpa(
                    fa.split_heads(q, HEADS), fa.split_heads(k, HEADS),
                    fa.split_heads(v, HEADS), sm, mask)), True),
                (f"built {label(built)}",
                 (lambda: fa.flash_fwd(q, k, v, HEADS, sm)) if keep is None
                 else (lambda: fa.flash_fwd_masked(q, k, v, HEADS, sm,
                                                   keep)), True)]
            here += [
                (label(c[1:]), common.refused_as_value_error(
                    functools.partial(fa._launch_fwd, q, k, v, HEADS, sm,
                                      keep, libs[c])), True)
                for c in cands if c[0] == padded(d) and c in libs]
            common.run_candidates(label_, here, ref,
                                  4.0 * HEADS * sq * kept * d, dev, card,
                                  iters, graph=True)
            del ref
        if "lse" in kinds:
            with torch.no_grad():
                lse_ref = fa.flash_lse_plain(q.float(), k.float(), HEADS,
                                             sm, keep)
            lb = fa.lse_tile(d, keep is not None)
            lse_here = [(f"built L {lb[0]}/{lb[2]}h/{lb[3]}s",
                         lambda: fa.flash_lse(q, k, HEADS, sm, keep), True)]
            lse_here += [
                (label(c[1:]),
                 functools.partial(fa._launch_lse, q, k, HEADS, sm, keep,
                                   lse_libs[c]), True)
                for c in lse_cands if c[0] == padded(d) and c in lse_libs]
            common.run_candidates(label_, lse_here, lse_ref,
                                  2.0 * HEADS * sq * kept * d, dev, card,
                                  iters)
            del lse_ref
        del q, k, v


if __name__ == "__main__":
    parser = common.arg_parser(__doc__)
    parser.add_argument("--kinds", default="fwd,lse",
                        help="comma-separated: fwd (F and M), lse (L)")
    args = parser.parse_args()
    main(**common.cli_kwargs(args), kinds=tuple(args.kinds.split(",")))
