"""Which tile of kernel G (csrc/geglu_matmul.cu) is fastest at each of its
sites on the card.

Kernel G picks its instantiation by the key (E, m_class(M))
(ops/geglu.py::geglu_tile). For the key of each site below, the study
builds the source once per candidate tile (BM, BE, BK, warps along M and
E, ring stages, split-K), each into its own library whose only
SG_BUILT line is that candidate's, one nvcc per candidate, all started
together, under build/storygen_tpu_torch/geglu_tiles/, and prints ptxas's
registers and spills of each. Then it times each candidate, the built
kernel (the `geglu_matmul` wrapper), its plain version and, labelled
"unfused", the bf16 chain F.linear(value * F.gelu(gate), W, b) (a
yardstick only: three launches and the gated product through HBM), with
the max error against the fp32 plain version. The sites are the feed-
forwards of the 512 px UNet: the serving main pass (3-row CFG batch), its
reference pass (6 rows), stage-2 training (batch 4) and its reference
pass (12 rows), a 256 px micro-step's second level, and the keys that
only a 128 px image reaches.

On the card by default; `--device cpu` runs the plain versions only (the
wrapper's CPU path), with host-clock times that say nothing about the card.

Usage: python -m storygen_tpu_torch.studies.geglu_tiles
           [--device cpu] [--shapes L1_main,...] [--iters N]
"""
from __future__ import annotations

import ctypes
import re
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from storygen_tpu_torch.ops import _build, geglu
from storygen_tpu_torch.studies import common

# site -> (M, N, E): proj (M, 2N), weight (E, N)
SHAPES = {
    "L1_main": (12288, 1280, 320),
    "L2_main": (3072, 2560, 640),
    "L3_main": (768, 5120, 1280),
    "mid_main": (192, 5120, 1280),
    "L1_ref": (24576, 1280, 320),
    "L2_ref": (6144, 2560, 640),
    "mid_ref": (384, 5120, 1280),
    "L1_train": (16384, 1280, 320),
    "L2_train": (4096, 2560, 640),
    "L3_train": (1024, 5120, 1280),
    "mid_train": (256, 5120, 1280),
    "L3_train_ref": (3072, 5120, 1280),
    "L2_train_256px": (1024, 2560, 640),
    # the keys that no 512 px site reaches: a 128 px image
    "L1_128px": (512, 1280, 320),
    "L2_128px": (384, 2560, 640),
    "L1_train_128px": (1024, 1280, 320),
}

Tile = Tuple[int, int, int, int, int, int, int]
# (E, M class) -> candidate tiles (BM, BE, BK, WM, WE, stages, split)
CANDIDATES: Dict[tuple, List[Tile]] = {
    # L1: the whole E = 320 in one block reads proj once; W, re-read from
    # L2 by every block, is 2.5x proj's bytes at BM = 64 and half that at
    # 128 (160 accumulators a thread, or 16 warps)
    (320, 2): [(64, 320, 64, 2, 4, 3, 1), (64, 320, 32, 2, 4, 4, 1),
               (128, 320, 32, 2, 4, 3, 1), (128, 320, 64, 2, 4, 2, 1),
               (64, 160, 64, 2, 2, 3, 1)],
    (640, 2): [(64, 320, 64, 2, 4, 3, 1), (64, 160, 64, 2, 2, 3, 1),
               (128, 320, 32, 2, 4, 3, 1), (64, 320, 32, 2, 4, 6, 1)],
    (1280, 2): [(128, 256, 64, 2, 4, 3, 1), (64, 256, 64, 2, 4, 3, 1),
                (128, 256, 32, 2, 4, 5, 1)],
    # few rows: split-K fills the card
    (1280, 1): [(64, 256, 64, 2, 4, 3, 2), (64, 256, 64, 2, 4, 3, 4),
                (128, 256, 64, 2, 4, 3, 2), (64, 128, 64, 2, 2, 3, 2)],
    (1280, 0): [(32, 128, 64, 1, 4, 3, 4), (32, 128, 64, 1, 4, 3, 8),
                (64, 256, 64, 2, 4, 3, 4), (64, 128, 64, 2, 2, 3, 4)],
    (640, 1): [(32, 320, 64, 1, 4, 3, 2), (32, 320, 64, 1, 4, 3, 4),
               (64, 320, 64, 2, 4, 3, 2)],
    (640, 0): [(32, 320, 64, 1, 4, 3, 4), (32, 320, 64, 1, 4, 3, 8),
               (32, 160, 64, 1, 2, 3, 4)],
    (320, 1): [(32, 320, 64, 1, 4, 3, 2), (64, 320, 64, 2, 4, 3, 2),
               (32, 320, 64, 1, 4, 3, 1)],
    (320, 0): [(32, 320, 64, 1, 4, 3, 4), (32, 320, 64, 1, 4, 3, 2),
               (32, 160, 64, 1, 2, 3, 4)],
}
SOURCE = "geglu_matmul.cu"
_BUILT_LINE = re.compile(r"^[ \t]*SG_BUILT\(\d[^)]*\)[ \t]*\n", re.M)


def shared_bytes(tile: Tile) -> int:
    """Dynamic shared memory of an instantiation: its ring of value, gate
    and W tiles (csrc/geglu_matmul.cu's GegluCfg::BYTES)."""
    bm, be, bk, _, _, stages, _ = tile
    row = 2 * bk if (2 * bk // 16) % 2 else 2 * bk + 16  # odd 16-byte units

    def a128(x):
        return (x + 127) // 128 * 128

    return stages * (2 * a128(bm * row) + a128(be * row))


def shape_key(shape) -> tuple:
    _, m, n, e = spec(shape)
    return e, geglu.m_class(m)


def spec(shape) -> tuple:
    """A name of SHAPES, or a (name, M, N, E) tuple as it is."""
    return (shape, *SHAPES[shape]) if isinstance(shape, str) else tuple(shape)


def candidate_source(key: tuple, tile: Tile) -> str:
    """geglu_matmul.cu with its SG_BUILT lines replaced by one: `tile`
    under `key`."""
    src = (_build.CSRC / SOURCE).read_text()
    first = _BUILT_LINE.search(src)
    if first is None:
        raise ValueError(f"{SOURCE} has no SG_BUILT lines")
    body = _BUILT_LINE.sub("", src)
    mine = f"  SG_BUILT({', '.join(map(str, key + tuple(tile)))})\n"
    return body[:first.start()] + mine + body[first.start():]


def build(cands: Sequence[Tuple[tuple, Tile]]) -> Dict[tuple, Path]:
    """One library per (key, tile), keyed by the sources' hash, built in
    parallel, each printing its ptxas registers and spills; a candidate
    that does not build prints FAILED and is left out."""
    root = (_build.BUILD_ROOT / "geglu_tiles"
            / _build.source_hash([_build.CSRC / SOURCE]))
    return common.build_candidates(
        root, {(key, tile): ("geglu_" + "_".join(map(str, key + tuple(tile))),
                             candidate_source(key, tile))
               for key, tile in cands}, "geglu_mma_kernel")


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.sg_geglu_matmul.argtypes = list(_build.SIGNATURES["sg_geglu_matmul"])
    lib.sg_geglu_matmul.restype = ctypes.c_int
    return lib


def inputs(shape, dev: torch.device, seed: int = 0):
    """Seeded bf16 proj (M, 2N), weight (E, N) and bias (E)."""
    _, m, n, e = spec(shape)
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    return rnd(m, 2 * n), rnd(e, n, scale=n ** -0.5), rnd(e)


def unfused(proj, w, bias):
    """The bf16 chain without kernel G (a yardstick, not G's function: the
    gated product is rounded where PyTorch rounds it)."""
    n = w.shape[1]
    return F.linear(proj[:, :n] * F.gelu(proj[:, n:]), w, bias)


def main(device=None, shapes=tuple(SHAPES), iters: int = 10) -> None:
    dev, card = common.setup(device)
    on_card = dev.type == "cuda"
    libs = {}
    if on_card:
        cands = sorted({(shape_key(s), t) for s in shapes
                        for t in CANDIDATES.get(shape_key(s), [])})
        libs = {c: load(p) for c, p in build(cands).items()}
    for shape in shapes:
        name, m, n, e = spec(shape)
        key = shape_key(shape)
        p, w, bias = inputs(shape, dev)
        with torch.no_grad():
            ref = geglu.geglu_matmul_plain(p.float(), w.float(), bias.float())
        rows = [(f"plain{' (cpu)' if not on_card else ''}",
                 lambda: geglu.geglu_matmul_plain(p, w, bias), True),
                ("built", lambda: geglu.geglu_matmul(p, w, bias), True)]
        if on_card:
            rows.insert(0, ("unfused (yardstick)",
                            lambda: unfused(p, w, bias), True))
            for tile in CANDIDATES.get(key, []):
                if (key, tile) not in libs:
                    continue
                rows.append(("x".join(map(str, tile)),
                             common.refused_as_value_error(
                                 lambda t=tile: geglu._launch(
                                     p, w, bias, lib=libs[(key, t)], tile=t)),
                             True))
        common.run_candidates(f"{name} ({m}, 2x{n})->{e} {key}", rows, ref,
                              2.0 * m * n * e, dev, card, iters)
        del p, w, bias, ref


if __name__ == "__main__":
    args = common.arg_parser(__doc__).parse_args()
    main(**common.cli_kwargs(args))
