"""Which tile of kernels F and M, and of the backward's logsumexp L (all
csrc/flash_fwd.cu on csrc/flash_wgmma.cuh), is fastest at each padded head
dim on the card.

Builds csrc/flash_fwd.cu once per candidate, each into its own library
whose only SG_BUILT lines are that candidate's, one nvcc per candidate, all
started together, under build/storygen_tpu_torch/tiles/, and prints
ptxas's registers and spills of each. An F / M candidate is (BQ, BK, ring
stages, Q / K panel columns, ping-pong) of flash_wg_kernel (BQ = 64 x
consumer warpgroups, ping-pong of its two consumer warpgroups); an L
candidate is (BQ, BK, ring stages, Q / K panel columns) of lse_wg_kernel.
Then times each candidate, the built kernel (the `flash_fwd` /
`flash_fwd_masked` / `flash_lse` wrappers) and, for F and M, SDPA as a
yardstick on the UNet's 512 px attention shapes of that head dim, with the
max error against the fp32 plain version, and each one's device time per
call replayed from a CUDA graph of 20 calls, which decides where the host
sets the mean's pace (d 160). The rate counts the kept kv rows only.

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

# 16-padded head dim -> F / M candidates (BQ, BK, stages, panel columns,
# ping-pong)
CANDIDATES: Dict[int, List[Tuple[int, int, int, int, int]]] = {
    48: [(128, 128, 2, 64, 1), (128, 128, 2, 64, 0), (128, 128, 3, 64, 1),
         (128, 64, 2, 64, 1), (128, 128, 2, 16, 1), (128, 64, 3, 16, 1),
         (192, 128, 2, 64, 0)],
    80: [(128, 128, 2, 16, 1), (128, 128, 2, 16, 0), (128, 128, 2, 64, 1),
         (128, 64, 2, 16, 1), (128, 64, 3, 16, 1), (128, 128, 3, 16, 1)],
    160: [(128, 64, 2, 32, 1), (128, 64, 2, 32, 0), (128, 64, 3, 32, 1),
          (128, 128, 2, 32, 1), (128, 64, 2, 16, 1), (192, 64, 2, 32, 0)],
}
# L: a ring of K alone (half of F's bytes a stage) and no O registers, so
# deeper rings and three consumer warpgroups fit; (BQ, BK, stages, panel
# columns). Three warpgroups with BK 128 (two 64-register accumulator
# sets in 152 registers) ran 2.3x slower than two.
LSE_CANDIDATES: Dict[int, List[Tuple[int, int, int, int]]] = {
    48: [(128, 128, 4, 64), (128, 128, 2, 64), (128, 64, 4, 64),
         (192, 64, 4, 64), (192, 64, 6, 64), (128, 128, 6, 64)],
    80: [(128, 128, 3, 64), (128, 64, 4, 64), (192, 64, 4, 64),
         (128, 128, 3, 16)],
    160: [(128, 64, 3, 32), (128, 64, 4, 32), (192, 64, 3, 32),
          (128, 128, 2, 32)],
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
    if len(cand) == 4:
        bq, bk, stages, a = cand
        return f"L {bq}/{bk} {stages}s p{a}"
    bq, bk, stages, a, b = cand
    return f"wgmma {bq}/{bk} {stages}s p{a}{' pp' if b else ''}"


def candidate_source(dp: int, *cand, kind: str = "fwd") -> str:
    """flash_fwd.cu with its SG_BUILT lines replaced by the candidate's two:
    kernel `kind` ("fwd" for F and M, `cand` = (BQ, BK, stages, panel
    columns, ping-pong); "lse" for L, `cand` = (BQ, BK, stages, panel
    columns)), unmasked and masked at 16-padded head dim dp."""
    src = (_build.CSRC / SOURCE).read_text()
    first = _BUILT_LINE.search(src)
    if first is None:
        raise ValueError(f"{SOURCE} has no SG_BUILT lines")
    body = _BUILT_LINE.sub("", src)
    args = [(m, *cand) for m in (0, 1)]
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
            lse_here = [(f"built {label(lb)}",
                         lambda: fa.flash_lse(q, k, HEADS, sm, keep), True)]
            lse_here += [
                (label(c[1:]),
                 functools.partial(fa._launch_lse, q, k, HEADS, sm, keep,
                                   lse_libs[c]), True)
                for c in lse_cands if c[0] == padded(d) and c in lse_libs]
            common.run_candidates(label_, lse_here, lse_ref,
                                  2.0 * HEADS * sq * kept * d, dev, card,
                                  iters, graph=True)
            del lse_ref
        del q, k, v


if __name__ == "__main__":
    parser = common.arg_parser(__doc__)
    parser.add_argument("--kinds", default="fwd,lse",
                        help="comma-separated: fwd (F and M), lse (L)")
    args = parser.parse_args()
    main(**common.cli_kwargs(args), kinds=tuple(args.kinds.split(",")))
