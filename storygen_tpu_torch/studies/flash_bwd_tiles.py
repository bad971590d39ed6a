"""Which tile of kernels DQ and DKV (csrc/flash_bwd.cu) is fastest at each
padded head dim on the card.

Builds csrc/flash_bwd.cu once per candidate, each into its own library
whose only SG_BUILT lines are that candidate's two (unmasked and masked),
one nvcc per candidate, all started together, under
build/storygen_tpu_torch/bwd_tiles/, and prints ptxas's registers, stack
and spills of each. A candidate is a line of csrc/flash_bwd_wgmma.cuh's
template: (BR own rows per block, 64 per consumer warpgroup; BC rows per
streamed tile; ring stages; own panel columns; ping-pong of the two
consumer warpgroups). Then times each candidate and the built kernel (the
`flash_dq` / `flash_dkv` wrappers) on the UNet's 512 px training backward
shapes of that head dim (batch 4, 8 heads), with the max error against
the fp32 plain version and each one's device time per call replayed from
a CUDA graph of 20 calls. The rate counts the kept kv rows only: 3
products for DQ, 4 for DKV.

The candidates need the card and nvcc; there is no CPU mode.

Usage: python -m storygen_tpu_torch.studies.flash_bwd_tiles
           [--shapes attn1_L1,...] [--iters N]
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

Tile = Tuple[int, int, int, int, int]
# (kernel, 16-padded head dim) -> candidates (BR, BC, stages, own panel
# columns, ping-pong); the 2-stage lines at d 48 show what the ring's
# depth is worth (a streamed tile stays in use from its logits to its
# gradients one iteration later)
CANDIDATES: Dict[Tuple[str, int], List[Tile]] = {
    ("dq", 48): [(128, 64, 4, 64, 1), (128, 64, 4, 64, 0),
                 (128, 128, 4, 64, 1), (128, 128, 4, 64, 0),
                 (128, 128, 3, 64, 1), (128, 64, 5, 64, 1),
                 (128, 128, 2, 64, 1)],
    ("dq", 80): [(128, 64, 4, 64, 1), (128, 64, 3, 64, 1),
                 (128, 128, 3, 64, 1), (128, 128, 4, 64, 1),
                 (128, 128, 4, 16, 1)],
    ("dq", 160): [(64, 64, 3, 32, 0), (64, 64, 4, 32, 0),
                  (64, 64, 2, 32, 0), (128, 64, 3, 32, 1)],
    ("dkv", 48): [(128, 64, 4, 64, 1), (128, 64, 5, 64, 1),
                  (128, 64, 6, 64, 1), (128, 64, 4, 64, 0),
                  (64, 64, 4, 64, 0), (128, 64, 2, 64, 1)],
    ("dkv", 80): [(128, 64, 4, 64, 1), (128, 64, 3, 64, 1),
                  (128, 64, 5, 64, 1), (128, 64, 4, 16, 1)],
    ("dkv", 160): [(64, 16, 3, 32, 0), (64, 16, 2, 32, 0),
                   (64, 16, 4, 32, 0), (64, 16, 3, 16, 0),
                   (64, 32, 3, 32, 0)],
}
# the UNet's attention sites in a 512 px stage-2 backward: (B, Sq, Skv, d,
# keep table or None), 8 heads; attn3's table as in chip_smoke.py
KEEP = [[0, 0, 1], [0, 1, 1], [1, 1, 1], [0, 0, 1]]
SHAPES = {
    "attn1_L1": (4, 4096, 4096, 40, None),
    "masked_attn3_L1": (4, 4096, 12288, 40, KEEP),
    "attn2_L1": (4, 4096, 77, 40, None),
    "attn1_L2": (4, 1024, 1024, 80, None),
    "masked_attn3_L2": (4, 1024, 3072, 80, KEEP),
    "attn1_L3": (4, 256, 256, 160, None),
    "masked_attn3_L3": (4, 256, 768, 160, KEEP),
    "attn1_mid": (4, 64, 64, 160, None),
    "masked_attn3_mid": (4, 64, 192, 160, KEEP),
}
HEADS = 8
KINDS = {"dq": "kDq", "dkv": "kDkv"}
_BUILT_LINE = re.compile(r"^[ \t]*SG_BUILT\(k\w+,[^)]*\)[ \t]*\n", re.M)


def padded(d: int) -> int:
    return (d + 15) // 16 * 16


def candidate_source(kernel: str, dp: int, tile: Tile) -> str:
    """flash_bwd.cu with its SG_BUILT lines replaced by the candidate's two
    (`kernel` at 16-padded head dim dp, unmasked and masked)."""
    src = (_build.CSRC / "flash_bwd.cu").read_text()
    first = _BUILT_LINE.search(src)
    if first is None:
        raise ValueError("flash_bwd.cu has no SG_BUILT lines")
    body = _BUILT_LINE.sub("", src)
    mine = "".join(f"  SG_BUILT({KINDS[kernel]}, {dp}, {m}, "
                   f"{', '.join(map(str, tile))})\n" for m in (0, 1))
    return body[:first.start()] + mine + body[first.start():]


def _tag(c) -> str:
    kernel, dp, tile = c
    return f"{kernel}_{dp}_{'_'.join(map(str, tile))}"


def build(cands) -> Dict[tuple, Path]:
    """One library per (kernel, dp, tile), keyed by the sources' hash and
    the candidate, built in parallel, each printing its ptxas registers
    and spills; a candidate that does not build prints FAILED and is left
    out."""
    root = (_build.BUILD_ROOT / "bwd_tiles"
            / _build.source_hash([_build.CSRC / "flash_bwd.cu"]))
    return common.build_candidates(
        root, {c: (f"flash_bwd_{_tag(c)}", candidate_source(*c))
               for c in cands}, "flash_bwd_wg")


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name in ("sg_flash_dq", "sg_flash_dkv"):
        fn = getattr(lib, name)
        fn.argtypes = list(_build.SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib


def main(device=None, shapes=tuple(SHAPES), iters: int = 10) -> None:
    dev, card = common.setup(device)
    if dev.type != "cuda":
        raise RuntimeError("the tile candidates run on the card only")
    todo = [(n, *SHAPES[n]) for n in shapes]
    dps = sorted({padded(d) for *_, d, _ in todo})
    cands = [(kernel, dp, t) for kernel in KINDS for dp in dps
             for t in CANDIDATES[(kernel, dp)]]
    for kernel in KINDS:
        for dp in dps:
            for masked in (False, True):
                print(f"built {kernel} d{dp}{' masked' if masked else ''}: "
                      f"{_label(fa.bwd_tile(kernel, dp, masked))}",
                      flush=True)
    libs = {c: load(p) for c, p in build(cands).items()}
    g = torch.Generator(device=dev).manual_seed(0)
    for name, b, sq, skv, d, table in todo:
        q, k, v, dout = (torch.randn((b, s, HEADS * d), generator=g,
                                     device=dev).to(torch.bfloat16)
                         for s in (sq, skv, skv, sq))
        keep = (None if table is None else
                torch.tensor(table, dtype=torch.bool, device=dev))
        sm = d ** -0.5
        kept = b * skv if keep is None else (
            int(keep.sum().item()) * (skv // keep.shape[1]))
        with torch.no_grad():
            out = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                           HEADS, sm, keep).to(q.dtype)
            delta = fa.attention_delta(out, dout, HEADS)
            lse = fa.flash_lse_plain(q.float(), k.float(), HEADS, sm, keep)
            f32 = (q.float(), k.float(), v.float(), dout.float(), lse, delta)
            refs = {"dq": (fa.flash_dq_plain(*f32, HEADS, sm, keep),),
                    "dkv": fa.flash_dkv_plain(*f32, HEADS, sm, keep)}
        args = (q, k, v, dout, lse, delta, HEADS, sm, keep)
        ops = 2.0 * HEADS * sq * kept * d  # one product
        for kernel, wrapper, products in (("dq", fa.flash_dq, 3),
                                          ("dkv", fa.flash_dkv, 4)):
            built = fa.bwd_tile(kernel, d, keep is not None)
            rows = [(f"built {_label(built)}",
                     functools.partial(wrapper, *args))]
            rows += [(_label(c[2]),
                      functools.partial(fa._launch_bwd, kernel, *args,
                                        lib=libs[c]))
                     for c in cands
                     if c[:2] == (kernel, padded(d)) and c in libs]
            run(f"{kernel} {name} B{b} {sq}x{skv} d{d}", rows, refs[kernel],
                products * ops, dev, card, iters)
        del q, k, v, dout, out, refs


def _label(tile: Tile) -> str:
    br, bc, stages, apw, pp = tile
    return f"{br}/{bc} {stages}s p{apw}{' pp' if pp else ''}"


def run(name: str, rows, refs, ops: float, dev, card: str,
        iters: int) -> None:
    """One line per (label, fn): its time, rate, the max error of its
    outputs against `refs` and its device time from a CUDA graph of 20
    calls; a launch that the card refuses prints FAILED."""
    for label, fn in rows:
        try:
            with torch.no_grad():
                outs = fn()
                outs = outs if isinstance(outs, tuple) else (outs,)
                err = max(common.max_err(o, r) for o, r in zip(outs, refs))
                del outs
                ms = common.time_ms(fn, dev, iters)
                alone = common.graph_ms(fn)
        except (ValueError, RuntimeError) as e:
            print(f"{name:14s} {label:24s} FAILED {e}  [{card}]", flush=True)
            continue
        print(common.line(name, label, ms, ops, card, err)
              + f"  graph {alone:.4f} ms", flush=True)


if __name__ == "__main__":
    main(**common.cli_kwargs(common.arg_parser(__doc__).parse_args()))
