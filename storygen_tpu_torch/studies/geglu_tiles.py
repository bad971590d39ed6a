"""Which tile of kernel G (csrc/geglu_matmul.cu) is fastest at each of its
sites on the card.

Kernel G picks its instantiation by the key (E, site_class(rows per
image), K step) (ops/geglu.py::tile_key). For the key of each site below,
the study builds the source once per candidate tile (consumer
warpgroups, BE, WN, BK, TMA ring stages, split of N), each into its own
library whose only SG_BUILT line is that candidate's, one nvcc per
candidate, all started together, under
build/storygen_tpu_torch/geglu_tiles/, and prints ptxas's registers and
spills of each (and any wgmma that ptxas serialises). Then it times each
candidate, the built kernel (the `geglu_matmul` wrapper), its plain
version and, labelled "unfused", the bf16 chain F.linear(value *
F.gelu(gate), W, b) (a yardstick only: three launches and the gated
product through HBM), with the max error against the fp32 plain version
and, on the card, the device time per call replayed from a CUDA graph of
20 calls (common.graph_ms). The sites are the feed-forwards of the 512
px UNet: the serving main pass (3-row CFG batch), its reference pass (6
rows), stage-2 training (batch 4) and its reference pass (12 rows), a 256
px micro-step's second level, the keys that only a 64 px, 128 px or 768
px image reaches, and the first level's inner shard at tensor
parallelism 8 (N = 160, the only site whose N is not a multiple of 64).

With `ablate` it times instead the built line of each site's key with one
part of its work taken out of csrc/geglu_wgmma.cuh: the gelu (the gated
product becomes v ^ g), the products (the wgmma calls go), or both; each
variant's copy of the header is built beside its own library. What is
left shows what the TMA ring, the gelu and the products cost; the ablated
outputs are not G's and are not checked.

On the card by default; `--device cpu` runs the plain versions only (the
wrapper's CPU path), with host-clock times that say nothing about the card.

Usage: python -m storygen_tpu_torch.studies.geglu_tiles [tiles|ablate]
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

# site -> (M, N, E, rows per image): proj (M, 2N), weight (E, N)
SHAPES = {
    "L1_main": (12288, 1280, 320, 4096),
    "L2_main": (3072, 2560, 640, 1024),
    "L3_main": (768, 5120, 1280, 256),
    "mid_main": (192, 5120, 1280, 64),
    "L1_ref": (24576, 1280, 320, 4096),
    "L2_ref": (6144, 2560, 640, 1024),
    "L3_ref": (1536, 5120, 1280, 256),
    "mid_ref": (384, 5120, 1280, 64),
    "L1_train": (16384, 1280, 320, 4096),
    "L2_train": (4096, 2560, 640, 1024),
    "L3_train": (1024, 5120, 1280, 256),
    "mid_train": (256, 5120, 1280, 64),
    "L3_train_ref": (3072, 5120, 1280, 256),
    "L2_train_256px": (1024, 2560, 640, 256),
    # the keys that no 512 px site reaches: a 64 px or 128 px image's
    # first two levels, a 768 px image's third
    "L1_64px": (192, 1280, 320, 64),
    "L1_128px": (768, 1280, 320, 256),
    "L2_128px": (192, 2560, 640, 64),
    "L3_768px": (1728, 5120, 1280, 576),
    # a tensor-parallel rank's shard at tp = 8: N = 1280 / 8
    "L1_main_tp8": (12288, 160, 320, 4096),
}

Tile = Tuple[int, int, int, int, int, int]
# (E, site class, K step) -> candidate tiles (consumer warpgroups, BE, WN,
# BK, stages, split); a split's blocks form a cluster, so split <= 8
CANDIDATES: Dict[tuple, List[Tile]] = {
    # the first level: the whole E = 320 as two N = 160 products computes
    # each gelu once, by one warpgroup of 64 rows or two of 128; BK 32
    # doubles the ring's depth
    (320, 2, 64): [(2, 320, 160, 64, 3, 1), (2, 320, 160, 32, 6, 1),
                   (1, 320, 160, 64, 4, 1), (1, 320, 160, 32, 6, 1)],
    # the N = 160 shard: five 32-deep inner steps
    (320, 2, 32): [(2, 320, 160, 32, 6, 1), (1, 320, 160, 32, 6, 1)],
    (320, 1, 64): [(1, 320, 160, 64, 4, 2), (1, 320, 160, 64, 4, 1),
                   (2, 320, 160, 64, 3, 2)],
    (320, 0, 64): [(1, 320, 160, 64, 4, 8), (1, 320, 160, 64, 4, 4)],
    (640, 2, 64): [(1, 320, 160, 64, 4, 1), (1, 320, 160, 32, 6, 1),
                   (2, 320, 160, 64, 3, 1), (2, 256, 256, 64, 3, 1)],
    (640, 1, 64): [(1, 320, 160, 64, 4, 2), (1, 320, 160, 64, 4, 4)],
    (640, 0, 64): [(1, 320, 160, 64, 4, 8), (1, 320, 160, 64, 4, 4)],
    (1280, 2, 64): [(1, 320, 160, 64, 4, 1), (2, 320, 160, 64, 3, 1),
                    (2, 256, 256, 64, 3, 1)],
    # few rows: a split of N fills the card; W is read from HBM once
    (1280, 1, 64): [(1, 320, 160, 64, 4, 2), (1, 320, 160, 64, 4, 1),
                    (1, 256, 256, 64, 4, 2), (1, 256, 256, 64, 4, 1),
                    (2, 320, 160, 64, 3, 4), (2, 256, 256, 64, 3, 2),
                    (3, 128, 128, 64, 3, 2)],
    (1280, 0, 64): [(1, 256, 256, 64, 4, 4), (1, 256, 256, 64, 4, 8),
                    (1, 320, 160, 64, 4, 4), (1, 320, 160, 64, 4, 8),
                    (2, 320, 160, 64, 3, 8), (2, 256, 256, 64, 3, 8),
                    (3, 128, 128, 64, 3, 8)],
}
SOURCE = "geglu_matmul.cu"
HEADER = "geglu_wgmma.cuh"
# the header's gated product and its products, and what `ablate` puts in
# their place (a product ablated keeps its fragment live)
GATE = "af[j] = gated2(v[j], gt[j]);"
PRODUCTS = re.compile(
    r"WgMma<WN>::template run<0>\(\s*acc\[p\], af,\s*smem_desc\([^;]*;")
ABLATIONS = {
    "no gelu": [(GATE, "af[j] = v[j] ^ gt[j];")],
    "no products": [(PRODUCTS,
                     "acc[p][0] += __uint_as_float(af[0] ^ af[1] ^ af[3]);")],
}
ABLATIONS["neither"] = ABLATIONS["no gelu"] + ABLATIONS["no products"]
_BUILT_LINE = re.compile(r"^[ \t]*SG_BUILT\(\d[^)]*\)[ \t]*\n", re.M)


def shape_key(shape) -> tuple:
    """(E, site class, K step) of a site: the K step 64 where it divides
    N, else 32 (geglu.tile_key at a built site; any width here)."""
    _, _, n, e, tokens = spec(shape)
    return e, geglu.site_class(tokens), 64 if n % 64 == 0 else 32


def spec(shape) -> tuple:
    """A name of SHAPES, or a (name, M, N, E, rows per image) tuple as it
    is."""
    return (shape, *SHAPES[shape]) if isinstance(shape, str) else tuple(shape)


def candidate_source(key: tuple, tile: Tile) -> str:
    """geglu_matmul.cu with its SG_BUILT lines replaced by one: `tile`
    under `key`'s (E, site class)."""
    src = (_build.CSRC / SOURCE).read_text()
    first = _BUILT_LINE.search(src)
    if first is None:
        raise ValueError(f"{SOURCE} has no SG_BUILT lines")
    body = _BUILT_LINE.sub("", src)
    mine = f"  SG_BUILT({', '.join(map(str, key[:2] + tuple(tile)))})\n"
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
               for key, tile in cands}, "geglu_wg_kernel")


def ablated_header(edits) -> str:
    """geglu_wgmma.cuh with each (text or pattern, replacement) of `edits`
    made once; ValueError if one does not match exactly once."""
    text = (_build.CSRC / HEADER).read_text()
    for old, new in edits:
        pattern = old if isinstance(old, re.Pattern) else re.compile(
            re.escape(old))
        text, n = pattern.subn(new, text)
        if n != 1:
            raise ValueError(f"ablation edit {pattern.pattern!r} matched {n} "
                             f"times")
    return text


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.sg_geglu_matmul.argtypes = list(_build.SIGNATURES["sg_geglu_matmul"])
    lib.sg_geglu_matmul.restype = ctypes.c_int
    return lib


def inputs(shape, dev: torch.device, seed: int = 0):
    """Seeded bf16 proj (M, 2N), weight (E, N) and bias (E)."""
    _, m, n, e, _ = spec(shape)
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
        name, m, n, e, tokens = spec(shape)
        key = shape_key(shape)
        p, w, bias = inputs(shape, dev)
        with torch.no_grad():
            ref = geglu.geglu_matmul_plain(p.float(), w.float(), bias.float())
        rows = [(f"plain{' (cpu)' if not on_card else ''}",
                 lambda: geglu.geglu_matmul_plain(p, w, bias), True),
                ("built", lambda: geglu.geglu_matmul(p, w, bias, tokens),
                 True)]
        if on_card:
            rows.insert(0, ("unfused (yardstick)",
                            lambda: unfused(p, w, bias), True))
            for tile in CANDIDATES.get(key, []):
                if (key, tile) not in libs:
                    continue
                rows.append(("x".join(map(str, tile)),
                             common.refused_as_value_error(
                                 lambda t=tile: geglu._launch(
                                     p, w, bias, tokens,
                                     lib=libs[(key, t)])),
                             True))
        common.run_candidates(f"{name} ({m}, 2x{n})->{e} {key}", rows, ref,
                              2.0 * m * n * e, dev, card, iters, graph=True)
        del p, w, bias, ref


def ablate(device=None, shapes=("L1_main", "L1_ref", "L3_main", "L3_ref"),
           iters: int = 10) -> None:
    """Each site's built line, whole and with each ABLATIONS entry, timed
    on the card (mean and CUDA-graph device time)."""
    dev, card = common.setup(device)
    if dev.type != "cuda":
        raise RuntimeError("the ablation builds kernels: it needs the card")
    keys = sorted({shape_key(s) for s in shapes})
    libs = {}
    for variant, edits in [("whole", [])] + list(ABLATIONS.items()):
        root = (_build.BUILD_ROOT / "geglu_ablate"
                / _build.source_hash([_build.CSRC / SOURCE])
                / variant.replace(" ", "_"))
        root.mkdir(parents=True, exist_ok=True)
        # the candidates include this copy of the header, not csrc's
        (root / HEADER).write_text(ablated_header(edits))
        built = common.build_candidates(
            root, {key: ("geglu_" + "_".join(map(str, key)),
                         candidate_source(key, geglu.GEGLU_BUILT[key]))
                   for key in keys}, "geglu_wg_kernel")
        libs.update({(variant, k): load(p) for k, p in built.items()})
    for shape in shapes:
        name, m, n, e, tokens = spec(shape)
        p, w, bias = inputs(shape, dev)
        rows = [(f"{variant} {'x'.join(map(str, geglu.GEGLU_BUILT[key]))}",
                 lambda lib=lib: geglu._launch(p, w, bias, tokens, lib=lib),
                 False)
                for (variant, key), lib in libs.items()
                if key == shape_key(shape)]
        common.run_candidates(f"{name} ({m}, 2x{n})->{e}", rows, None,
                              2.0 * m * n * e, dev, card, iters, graph=True)
        del p, w, bias


if __name__ == "__main__":
    args = common.arg_parser(__doc__, ("tiles", "ablate")).parse_args()
    {"tiles": main, "ablate": ablate}[args.mode](**common.cli_kwargs(args))
