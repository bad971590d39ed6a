"""Which tile of kernels F and M (csrc/flash_fwd.cu) is fastest at each
padded head dim on the card.

Builds csrc/flash_fwd.cu once per candidate (BQ, 16-row halves per warp,
cp.async ring stages), each into its own library whose only SG_BUILT lines
are that candidate's (BK, the K/V tile height, stays 64), one nvcc per
candidate, all started together, under build/storygen_tpu_torch/tiles/,
and prints ptxas's registers and spills of each. Then times each
candidate, the built
kernel (the `flash_fwd` / `flash_fwd_masked` wrappers) and SDPA as a
yardstick on the UNet's 512 px attention shapes of that head dim, F and M,
with the max error against the fp32 plain version. The rate counts the
kept kv rows only.

The candidates need the card and nvcc; there is no CPU mode.

Usage: python -m storygen_tpu_torch.studies.flash_fwd_tiles
           [--shapes attn3_L1,...] [--iters N]
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

# 16-padded head dim -> candidate (BQ, halves, stages)
CANDIDATES: Dict[int, List[Tuple[int, int, int]]] = {
    48: [(64, 1, 2), (64, 2, 2), (128, 1, 2), (128, 2, 2), (64, 2, 3),
         (128, 2, 3)],
    80: [(64, 1, 2), (64, 2, 2), (128, 1, 2), (128, 2, 2), (64, 1, 3)],
    160: [(64, 1, 2), (128, 1, 2), (64, 1, 3)],
}
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
}
HEADS = 8
_BUILT_LINE = re.compile(r"^[ \t]*SG_BUILT\((\d+),[^)]*\)[ \t]*\n", re.M)


def padded(d: int) -> int:
    return (d + 15) // 16 * 16


def candidate_source(dp: int, bq: int, halves: int, stages: int) -> str:
    """flash_fwd.cu with its SG_BUILT lines replaced by the candidate's two
    (F and M at 16-padded head dim dp)."""
    src = (_build.CSRC / "flash_fwd.cu").read_text()
    first = _BUILT_LINE.search(src)
    if first is None:
        raise ValueError("flash_fwd.cu has no SG_BUILT lines")
    body = _BUILT_LINE.sub("", src)
    mine = "".join(f"  SG_BUILT({dp}, {m}, {bq}, {fa._BK}, {halves}, "
                   f"{stages})\n" for m in (0, 1))
    return body[:first.start()] + mine + body[first.start():]


def build(cands) -> Dict[tuple, Path]:
    """One library per (dp, bq, halves, stages), keyed by the sources' hash
    and the candidate, built in parallel, each printing its ptxas
    registers and spills."""
    root = (_build.BUILD_ROOT / "tiles"
            / _build.source_hash([_build.CSRC / "flash_fwd.cu"]))
    return common.build_candidates(
        root, {c: (f"flash_fwd_{'_'.join(map(str, c))}",
                   candidate_source(*c)) for c in cands},
        "flash_fwd_kernel")


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.sg_flash_fwd.argtypes = list(_build.SIGNATURES["sg_flash_fwd"])
    lib.sg_flash_fwd.restype = ctypes.c_int
    return lib


def main(device=None, shapes=tuple(SHAPES), iters: int = 10) -> None:
    dev, card = common.setup(device)
    if dev.type != "cuda":
        raise RuntimeError("the tile candidates run on the card only")
    todo = [(n, *SHAPES[n]) for n in shapes]
    dps = sorted({padded(d) for *_, d, _ in todo})
    cands = [(dp, *c) for dp in dps for c in CANDIDATES[dp]]
    libs = {c: load(p) for c, p in build(cands).items()}
    g = torch.Generator(device=dev).manual_seed(0)
    for name, b, sq, skv, d, table in todo:
        q, k, v = (torch.randn((b, s, HEADS * d), generator=g, device=dev)
                   .to(torch.bfloat16) for s in (sq, skv, skv))
        keep = (None if table is None else
                torch.tensor(table, dtype=torch.bool, device=dev))
        sm = d ** -0.5
        kept = b * skv if keep is None else (
            int(keep.sum().item()) * (skv // keep.shape[1]))
        with torch.no_grad():
            ref = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                           HEADS, sm, keep)
        mask = None if keep is None else fa.keep_to_mask(keep, skv)
        built = fa.fwd_tile(d, keep is not None)
        cands_here = [
            ("sdpa (yardstick)", lambda: fa.merge_heads(common.sdpa(
                fa.split_heads(q, HEADS), fa.split_heads(k, HEADS),
                fa.split_heads(v, HEADS), sm, mask)), True),
            (f"built {built[0]}/{built[2]}h/{built[3]}s",
             (lambda: fa.flash_fwd(q, k, v, HEADS, sm)) if keep is None else
             (lambda: fa.flash_fwd_masked(q, k, v, HEADS, sm, keep)), True)]
        cands_here += [
            (f"bq{bq} {halves}h {stages}s",
             functools.partial(fa._launch_fwd, q, k, v, HEADS, sm, keep,
                               libs[(dp, bq, halves, stages)]), True)
            for dp, bq, halves, stages in cands if dp == padded(d)]
        label = f"{name} B{b} {sq}x{skv} d{d}"
        common.run_candidates(label, cands_here, ref,
                              4.0 * HEADS * sq * kept * d, dev, card, iters)
        del q, k, v, ref


if __name__ == "__main__":
    main(**common.cli_kwargs(common.arg_parser(__doc__).parse_args()))
