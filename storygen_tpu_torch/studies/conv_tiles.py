"""Which tile of the conv kernels C, P (csrc/conv3x3.cu) and D
(csrc/downconv3x3.cu) is fastest at each of their sites on the card.

Every kernel picks its instantiation by a key (stride, prologue, Cin % 8 !=
0, Cout class, W class of the output width; ops/conv.py::tile_key). For
the key of each shape below, the study builds the source once per
candidate, each into its own library whose only SG_BUILT line is that
candidate's, one nvcc per candidate, all started together, under
build/storygen_tpu_torch/conv_tiles/, and prints each one's ptxas
registers and spills. A candidate names its family: the wgmma template of
csrc/conv_wgmma.cuh (TH, TW, images a block, consumer warpgroups, 64-row
tiles a warpgroup, BN, CK, ring stages; it splits the reduction as
ops/conv.py::split_count plans for that tile), at stride 1 or 2, or the
mma.sync template of csrc/conv_mma.cuh (TH, TW, BN, warps along M and N,
CK, ring stages, blocks per SM), so each stride-1 wgmma key is timed
against its mma.sync line too; D's candidates are wgmma tiles. Then it
times each
candidate, the built kernel (the `conv3x3` / `gnconv3x3` / `downconv3x3`
wrappers) and cuDNN's bf16 channels_last convolution as a yardstick (not
for P, which has no one-call counterpart), with the max error against the
fp32 plain version, and on the card each one's device time per call
replayed from a CUDA graph of 20 calls (`common.graph_ms`), which decides
where the host sets the mean's pace (the UNet's few-pixel sites). A
candidate whose build the card refuses prints FAILED.

On the card by default; `--device cpu` runs the plain versions only (the
wrappers' CPU path), with host-clock times that say nothing about the card.

Usage: python -m storygen_tpu_torch.studies.conv_tiles
           [--device cpu] [--shapes unet_up_L1,...] [--iters N]
"""
from __future__ import annotations

import ctypes
import math
import re
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from storygen_tpu_torch.ops import _build, conv, downconv
from storygen_tpu_torch.studies import common

# (kernel, B, H, W, Cin, Cout, per-batch bias, residual, pad of D): the
# smoke's C, P and D cases, P at the UNet's 16- and 8-column resnets and
# the UNet's D sites at 32 and 16 px
SHAPES = {
    "unet_up_L1": ("C", 3, 64, 64, 960, 320, True, False, None),
    "unet_L1_res": ("C", 3, 64, 64, 320, 320, False, True, None),
    "vae_dec_512": ("C", 1, 512, 512, 256, 128, False, False, None),
    "vae_conv_in": ("C", 1, 512, 512, 3, 128, False, False, None),
    "vae_conv_out": ("C", 1, 512, 512, 128, 3, False, False, None),
    "unet_conv_in": ("C", 3, 64, 64, 4, 320, False, False, None),
    "unet_L3": ("C", 3, 16, 16, 1280, 1280, False, False, None),
    "unet_mid": ("C", 3, 8, 8, 1280, 1280, False, False, None),
    "unet_up_block1": ("C", 3, 8, 8, 2560, 1280, False, False, None),
    "unet_up_L1_dx": ("C", 3, 64, 64, 320, 960, False, False, None),
    "p_unet_L1_res": ("P", 3, 64, 64, 320, 320, False, True, None),
    "p_unet_up_L1": ("P", 3, 64, 64, 960, 320, True, False, None),
    "p_vae_dec_512_res": ("P", 1, 512, 512, 128, 128, False, True, None),
    "p_vae_enc_512": ("P", 3, 512, 512, 128, 128, False, False, None),
    "p_unet_L3": ("P", 3, 16, 16, 1280, 1280, True, True, None),
    "p_unet_mid": ("P", 3, 8, 8, 1280, 1280, True, True, None),
    "p_unet_up_block1": ("P", 3, 8, 8, 2560, 1280, True, False, None),
    "d_unet_L1": ("D", 3, 64, 64, 320, 320, False, False, (1, 1, 1, 1)),
    "d_unet_L2": ("D", 3, 32, 32, 640, 640, False, False, (1, 1, 1, 1)),
    "d_unet_L3": ("D", 3, 16, 16, 1280, 1280, False, False, (1, 1, 1, 1)),
    "d_vae_enc_512": ("D", 3, 512, 512, 128, 128, False, False,
                      (0, 1, 0, 1)),
    "d_vae_enc_128": ("D", 3, 128, 128, 512, 512, False, False,
                      (0, 1, 0, 1)),
}

Tile = Tuple[int, ...]
M, W = conv.MMA, conv.WGMMA
# key -> candidates: (family, then its tile). Each stride-1 wgmma key
# lists the mma.sync line it had before beside its wgmma tiles.
# A block's warps share an SM's four register files: with the producer
# warpgroup, 2 / 3 / 4 consumer warpgroups rise by setmaxnreg to 232 / 152
# / 104 registers a thread, which the accumulators (MT BN / 2) must fit.
_WIDE_128 = [(W, 6, 32, 1, 3, 1, 128, 32, 2), (W, 8, 16, 1, 2, 1, 128, 32, 2),
             (W, 8, 32, 1, 2, 2, 128, 32, 2), (W, 8, 32, 1, 4, 1, 128, 32, 2),
             (W, 6, 32, 1, 3, 1, 128, 16, 4), (M, 8, 32, 64, 4, 1, 16, 2, 2)]
_WIDE_160 = [(W, 6, 32, 1, 3, 1, 160, 32, 2), (W, 8, 16, 1, 2, 1, 160, 32, 2),
             (W, 6, 32, 1, 3, 1, 160, 16, 4), (W, 8, 16, 1, 2, 1, 160, 16, 4),
             (M, 8, 32, 64, 4, 1, 16, 2, 2)]
_W16_128 = [(W, 8, 16, 1, 2, 1, 128, 32, 2), (W, 16, 16, 1, 4, 1, 128, 32, 2),
            (W, 16, 16, 1, 2, 2, 128, 32, 2), (W, 8, 16, 1, 2, 1, 128, 16, 4),
            (M, 8, 16, 32, 4, 1, 32, 3, 2)]
_W16_160 = [(W, 8, 16, 1, 2, 1, 160, 32, 2), (W, 8, 16, 1, 2, 1, 160, 16, 4),
            (M, 8, 16, 32, 4, 1, 32, 3, 2)]
_W8_128 = [(W, 8, 8, 3, 3, 1, 128, 32, 2), (W, 8, 8, 3, 3, 1, 128, 16, 4),
           (W, 8, 8, 3, 3, 1, 64, 32, 3), (W, 8, 8, 2, 2, 1, 128, 32, 2),
           (M, 8, 8, 32, 4, 2, 64, 2, 1)]
_W8_160 = [(W, 8, 8, 3, 3, 1, 160, 32, 2), (W, 8, 8, 3, 3, 1, 160, 16, 4),
           (M, 8, 8, 32, 4, 2, 64, 2, 1)]
CANDIDATES: Dict[tuple, List[Tile]] = {
    # P takes C's line at every key, so both list the same candidates
    **{(1, pro, 0, 1, 2): _WIDE_128 for pro in (0, 1)},
    **{(1, pro, 0, 2, 2): _WIDE_160 for pro in (0, 1)},
    **{(1, pro, 0, 1, 1): _W16_128 for pro in (0, 1)},
    **{(1, pro, 0, 2, 1): _W16_160 for pro in (0, 1)},
    **{(1, pro, 0, 1, 0): _W8_128 for pro in (0, 1)},
    **{(1, pro, 0, 2, 0): _W8_160 for pro in (0, 1)},
    (1, 0, 0, 0, 2): [(M, 8, 16, 16, 4, 1, 32, 2, 4),
                      (M, 16, 16, 16, 4, 1, 32, 2, 2),
                      (M, 8, 32, 16, 4, 1, 32, 2, 2),
                      (M, 16, 16, 16, 8, 1, 32, 2, 1)],
    (1, 0, 1, 1, 2): [(M, 8, 16, 64, 4, 2, 16, 2, 2),
                      (M, 16, 16, 64, 4, 2, 16, 2, 1),
                      (M, 16, 16, 64, 8, 2, 16, 2, 1),
                      (M, 8, 16, 128, 2, 2, 16, 2, 2)],
    # D (stride 2): a plane pair of (2 TH + 1) x (TW + 1) half-columns a
    # chunk, twice a stride-1 slab's bytes for the same output tile
    (2, 0, 0, 1, 2): [(W, 8, 32, 1, 2, 2, 128, 16, 3),
                      (W, 4, 32, 1, 2, 1, 128, 32, 2),
                      (W, 4, 32, 1, 2, 1, 128, 16, 4),
                      (W, 6, 32, 1, 3, 1, 128, 16, 3),
                      (W, 8, 16, 1, 2, 1, 128, 16, 4),
                      (W, 8, 32, 1, 4, 1, 128, 16, 3)],
    (2, 0, 0, 2, 2): [(W, 4, 32, 1, 2, 1, 160, 16, 3),
                      (W, 6, 32, 1, 3, 1, 160, 16, 3),
                      (W, 8, 16, 1, 2, 1, 160, 16, 3)],
    (2, 0, 0, 1, 1): [(W, 8, 16, 1, 2, 1, 128, 16, 4),
                      (W, 8, 16, 1, 2, 1, 128, 32, 2),
                      (W, 16, 16, 1, 4, 1, 128, 16, 3),
                      (W, 16, 16, 1, 2, 2, 128, 16, 3)],
    (2, 0, 0, 2, 1): [(W, 8, 16, 1, 2, 1, 160, 16, 3),
                      (W, 16, 16, 1, 4, 1, 160, 16, 2)],
    (2, 0, 0, 1, 0): [(W, 8, 8, 3, 3, 1, 128, 16, 3),
                      (W, 8, 8, 3, 3, 1, 64, 32, 2),
                      (W, 8, 8, 2, 2, 1, 128, 16, 3),
                      (W, 8, 8, 3, 3, 1, 128, 16, 2)],
    (2, 0, 0, 2, 0): [(W, 8, 8, 3, 3, 1, 160, 16, 3),
                      (W, 8, 8, 2, 2, 1, 160, 16, 3)],
}
SOURCES = {1: "conv3x3.cu", 2: "downconv3x3.cu"}
EXPORTS = {1: ("sg_conv3x3", "sg_gnconv3x3"), 2: ("sg_downconv3x3",)}
_BUILT_LINE = re.compile(r"^[ \t]*SG_BUILT\(\d[^)]*\)[ \t]*\n", re.M)


def shared_bytes(tile: Tile) -> int:
    """Dynamic shared memory of a mma.sync instantiation: its ring of slab
    and weight chunks (csrc/conv_mma.cuh's ConvCfg::BYTES)."""
    th, tw, bn, _, _, ck, stages, _ = tile

    def pitch(b):  # an odd number of 16-byte units
        return b if (b // 16) % 2 else b + 16

    def a128(x):
        return (x + 127) // 128 * 128

    return stages * (a128((th + 2) * (tw + 2) * pitch(2 * ck))
                     + a128(9 * ck * pitch(2 * bn)))


def slab_box(stride: int, tile: Tile) -> Tuple[int, int, int, int]:
    """The TMA box of one plane of a wgmma instantiation's slab, (CK,
    columns, rows, IB): (TH+2) x (TW+2) pixels at stride 1, (2 TH + 1) x
    (TW + 1) half-columns of each of the two planes at stride 2."""
    th, tw, ib, _, _, _, ck, _ = tile
    if stride == 1:
        return ck, tw + 2, th + 2, ib
    return ck, tw + 1, 2 * th + 1, ib


def wg_stage_bytes(tile: Tile, stride: int = 1,
                   taps: int = 9) -> Tuple[int, int, int]:
    """A wgmma instantiation's ring stage (csrc/conv_wgmma.cuh's WgCfg): the
    bytes its slab's boxes land (`stride` planes of slab_box), of its BN /
    32 weight panels (`taps` CK rows of 64 bytes each: 9, or kernel U's 4
    of one phase), and of the stage (each plane rounded up to the
    1024-byte swizzle period, then the panels)."""
    bn = tile[5]
    plane = 2 * math.prod(slab_box(stride, tile))
    panels = bn // 32 * taps * tile[6] * 64
    return (stride * plane, panels,
            stride * ((plane + 1023) // 1024 * 1024) + panels)


def wg_shared_bytes(tile: Tile, stride: int = 1, taps: int = 9) -> int:
    """Dynamic shared memory of a wgmma instantiation: its ring, 1 KB to
    align it, and its full and empty barriers (WgCfg::BYTES)."""
    stages = tile[7]
    return (stages * wg_stage_bytes(tile, stride, taps)[2] + 1024
            + 16 * stages)


def spec(shape) -> tuple:
    """A name of SHAPES, or a (name, kernel, B, H, W, Cin, Cout, per-batch
    bias, residual, pad) tuple as it is."""
    return (shape, *SHAPES[shape]) if isinstance(shape, str) else tuple(shape)


def shape_key(shape) -> tuple:
    _, kind, b, h, w, cin, cout, _, _, pad = spec(shape)
    wo = w if pad is None else downconv.out_size(h, w, pad)[1]
    return conv.tile_key(2 if kind == "D" else 1, kind == "P", cin, cout,
                         wo)


def candidate_source(key: tuple, tile: Tile) -> str:
    """The source of key's stride with its SG_BUILT lines replaced by one:
    `tile` under `key`."""
    src = (_build.CSRC / SOURCES[key[0]]).read_text()
    first = _BUILT_LINE.search(src)
    if first is None:
        raise ValueError(f"{SOURCES[key[0]]} has no SG_BUILT lines")
    body = _BUILT_LINE.sub("", src)
    mine = f"  SG_BUILT({', '.join(map(str, key + tuple(tile)))})\n"
    return body[:first.start()] + mine + body[first.start():]


def build(cands: Sequence[Tuple[tuple, Tile]]) -> Dict[tuple, Path]:
    """One library per (key, tile), keyed by the sources' hash, built in
    parallel, each printing its ptxas registers and spills; a candidate
    that does not build prints FAILED and is left out."""
    root = (_build.BUILD_ROOT / "conv_tiles"
            / _build.source_hash([_build.CSRC / s for s in SOURCES.values()]))
    return common.build_candidates(
        root, {(key, tile): ("conv_" + "_".join(map(str, key + tuple(tile))),
                             candidate_source(key, tile))
               for key, tile in cands}, "conv_")


def load(path: Path, stride: int) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name in EXPORTS[stride]:
        fn = getattr(lib, name)
        fn.argtypes = list(_build.SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib


def inputs(shape, dev: torch.device, seed: int = 0):
    """Seeded bf16 x, w9, residual and fp32 bias, a, s of a shape."""
    _, kind, b, h, w, cin, cout, bias_b, res, _ = spec(shape)
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(
            torch.bfloat16)

    x = rnd(b, h, w, cin)
    w9 = rnd(9, cin, cout, s=(9 * cin) ** -0.5)
    bias = torch.randn((b, cout) if bias_b else (cout,), generator=g,
                       device=dev)
    r = rnd(b, h, w, cout) if res else None
    a = torch.rand((b, cin), generator=g, device=dev) + 0.5
    s = torch.randn((b, cin), generator=g, device=dev)
    return x, w9, bias, r, a, s


def main(device=None, shapes=tuple(SHAPES), iters: int = 10) -> None:
    dev, card = common.setup(device)
    torch.backends.cudnn.allow_tf32 = False
    on_card = dev.type == "cuda"
    libs = {}
    if on_card:
        cands = sorted({(shape_key(n), t) for n in shapes
                        for t in CANDIDATES.get(shape_key(n), [])})
        libs = {c: load(p, c[0][0]) for c, p in build(cands).items()}
    for shape in shapes:
        name, kind, b, h, w, cin, cout, bias_b, res, pad = spec(shape)
        key = shape_key(shape)
        x, w9, bias, r, a, s = inputs(shape, dev)
        if kind == "D":
            ho, wo = downconv.out_size(h, w, pad)
            plain = lambda: downconv.downconv3x3_plain(x, w9, bias, pad)
            built = lambda: downconv.downconv3x3(x, w9, bias, pad)
            ref = downconv.downconv3x3_plain(x.float(), w9.float(), bias, pad)
            t, bo, le, ri = pad
            x_lib = F.pad(x.permute(0, 3, 1, 2), (le, ri, t, bo))
            lib_pad, stride = 0, 2
        else:
            ho, wo = h, w
            pro = kind == "P"
            aff = (a, s) if pro else ()
            fn = conv.gnconv3x3 if pro else conv.conv3x3
            pfn = conv.gnconv3x3_plain if pro else conv.conv3x3_plain
            plain = lambda: pfn(x, w9, bias, *aff, r)
            built = lambda: fn(x, w9, bias, *aff, r)
            with torch.no_grad():
                ref = pfn(x.float(), w9.float(), bias, *aff,
                          None if r is None else r.float())
            x_lib = x.permute(0, 3, 1, 2)
            lib_pad, stride = 1, 1
        label = f"{name} {key}"
        rows = [(f"plain{' (cpu)' if not on_card else ''}", plain, True),
                ("built", built, True)]
        if on_card:
            w_lib = w9.reshape(3, 3, cin, cout).permute(3, 2, 0, 1) \
                .contiguous(memory_format=torch.channels_last)
            x_lib = x_lib.contiguous(memory_format=torch.channels_last)
            b_lib = None if bias_b else bias.to(torch.bfloat16)
            if kind != "P":
                rows.insert(0, ("cudnn (yardstick)", lambda: F.conv2d(
                    x_lib, w_lib, b_lib, stride=stride, padding=lib_pad),
                    False))
            for tile in CANDIDATES.get(key, []):
                if (key, tile) not in libs:
                    continue
                lib = libs[(key, tile)]
                tag = "x".join(map(str, tile))
                if kind == "D":
                    call = (lambda lib=lib, tile=tile: downconv._launch(
                        x, w9, bias, pad, lib=lib, line=tile))
                else:
                    call = (lambda lib=lib, tile=tile: conv._launch(
                        "sg_gnconv3x3" if pro else "sg_conv3x3", x, w9,
                        bias, r, *aff, lib=lib, line=tile))
                rows.append((tag, common.refused_as_value_error(call), True))
        common.run_candidates(label, rows, ref,
                              2.0 * b * ho * wo * 9 * cin * cout, dev, card,
                              iters, graph=True)
        del x, w9, bias, r, a, s, ref


if __name__ == "__main__":
    args = common.arg_parser(__doc__).parse_args()
    main(**common.cli_kwargs(args))
