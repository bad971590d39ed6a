"""The tiles of kernels C, P (csrc/conv3x3.cu), D (csrc/downconv3x3.cu) and
UB (csrc/upconv_dx3x3.cu, U's input gradient), without a card: the Python tables of built instantiations against the
sources' SG_BUILT lines, the shared memory and warp layout of every built
and candidate tile (for the wgmma lines also TMA's box rules and wgmma's
N), the wrappers' choice and split plan at the UNet's and the VAE's conv
sites (no batch in either), a ValueError for a key that is not built, the
tile study's rewrite of a source, the study's CPU path at a tiny shape,
and D's and UB's stride-2 slabs: where their two planes put each tap. The kernels
themselves run only on the card (chip_smoke.py)."""
import math
import re

import numpy as np
import pytest
import torch

from storygen_tpu_torch.ops import _build, conv, downconv, upconv
from storygen_tpu_torch.studies import conv_tiles

# a block's dynamic shared memory, and an SM's (each block takes 1 KB more)
BLOCK_SMEM, SM_SMEM = 232448, 233472


def _built_lines(src: str):
    """The integer arguments of every SG_BUILT invocation (not the macro's
    own definition)."""
    out = []
    for args in re.findall(r"^\s*SG_BUILT\(([^)]*)\)\s*$", src, re.M):
        if any(a.strip().endswith("_") for a in args.split(",")):
            continue
        out.append(tuple(int(a) for a in args.split(",")))
    return out


def _table(src_name: str) -> dict:
    lines = _built_lines((_build.CSRC / src_name).read_text())
    table = {line[:5]: line[5:] for line in lines}
    assert len(table) == len(lines)  # one line per key
    return table


def test_conv_built_matches_the_cuda_source():
    assert _table("conv3x3.cu") == conv.CONV_BUILT


def test_down_built_matches_the_cuda_source():
    assert _table("downconv3x3.cu") == downconv.DOWN_BUILT


def test_up_built_matches_the_cuda_source():
    assert _table("upconv3x3.cu") == upconv.UP_BUILT


def test_ub_built_matches_the_cuda_source():
    assert _table("upconv_dx3x3.cu") == upconv.UB_BUILT


def _check_tile(stride, tile):
    """The static_asserts of conv_mma.cuh's ConvCfg and conv_launch (a
    stride-1 line of family MMA), or of conv_wgmma.cuh's WgCfg (a line of
    family WGMMA, at stride 1 or 2)."""
    fam, tile = tile[0], tile[1:]
    if fam == conv.WGMMA:
        _check_wgmma_tile(stride, tile)
        return
    assert fam == conv.MMA and stride == 1
    th, tw, bn, wm, wn, ck, stages, minb = tile
    nt = 32 * wm * wn
    assert tw % 8 == 0 and (th * tw) % (16 * wm) == 0
    assert bn % (16 * wn) == 0 and ck % 16 == 0 and stages >= 2
    assert nt % (ck // 8) == 0 and nt <= 1024
    nbytes = conv_tiles.shared_bytes(tile)
    assert nbytes <= BLOCK_SMEM and minb * (nbytes + 1024) <= SM_SMEM


# the widths N whose register-A wgmma instruction (the WgMma that
# conv_wgmma.cuh runs) hopper.cuh spells out
WGMMA_N = {int(n) for n in re.findall(
    r"struct WgMma<(\d+)>", (_build.CSRC / "hopper.cuh").read_text())}


def _check_wgmma_tile(stride, tile, taps=9):
    """WgCfg's conditions on a wgmma line whose blocks walk `taps` taps (9,
    kernel U's 4 of a phase, or UB's 16 of its 4x4 window at stride 2)."""
    th, tw, ib, wgm, mt, bn, ck, stages = tile
    # the block's pixels fill its 64-row tiles; 8-pixel ldmatrix rows
    assert 64 * wgm * mt == ib * th * tw and tw % 8 == 0
    # the consumers and the producer warpgroup; each consumer thread keeps
    # one 8-channel unit of a chunk in P's prologue
    assert 128 * wgm + 128 <= 1024 and stages >= 2
    assert (128 * wgm) % (ck // 8) == 0
    # setmaxnreg: the consumers' rise fits the producer's release (WgCfg)
    regs = 512 // (wgm + 1) // 8 * 8
    cons = min(240, (regs + (regs - 40) // wgm) // 8 * 8)
    assert wgm * cons + 40 <= 512 and regs - 40 >= wgm * (cons - regs)
    assert cons >= mt * bn // 2 + 24  # the accumulators and some room
    # wgmma's N: a multiple of 8 up to 256, spelled out in the header; the
    # weights come in whole 32-column panels
    assert bn % 8 == 0 and bn <= 256 and bn % 32 == 0 and bn in WGMMA_N
    # TMA's boxes, (CK, TW+2, TH+2, IB) of x (stride 2: (CK, TW+1, 2 TH
    # + 1, IB) of each plane, UB's (CK, TW+2, 2 TH + 2, IB)) and (32, CK,
    # taps) of the weights: every dimension <= 256; the inner one a
    # multiple of 16 bytes and within its swizzle span (the slab's 2 CK
    # bytes, one of 32 / 64 / 128; the weights' 64)
    window = 4 if taps == 16 else 3
    assert taps != 16 or stride == 2
    xbox = ((ck, tw + 2, th + 2, ib) if stride == 1
            else (ck, tw + window // 2, 2 * th + window - 2, ib))
    assert conv_tiles.slab_box(stride, tile, window) == xbox
    for box in (xbox, (32, ck, taps)):
        assert all(1 <= d <= 256 for d in box)
    assert 2 * ck in (32, 64, 128)
    # a k step is 16 weight rows of 64 bytes: 1024 bytes, so every
    # descriptor start keeps the swizzle's phase; panels, planes and
    # stages are whole 1024-byte periods
    slab, panels, stage = conv_tiles.wg_stage_bytes(tile, stride, taps)
    assert panels == bn // 32 * taps * ck * 64
    assert panels % 1024 == 0 and stage % 1024 == 0
    assert slab == stride * math.prod(xbox) * 2
    assert conv_tiles.wg_shared_bytes(tile, stride, taps) <= BLOCK_SMEM


@pytest.mark.parametrize("key", sorted(conv.CONV_BUILT)
                         + sorted(downconv.DOWN_BUILT))
def test_every_built_tile_fits_an_sm(key):
    table = conv.CONV_BUILT if key[0] == 1 else downconv.DOWN_BUILT
    _check_tile(key[0], table[key])


@pytest.mark.parametrize("key", sorted(upconv.UP_BUILT))
def test_every_up_tile_fits_an_sm(key):
    """Kernel U's lines: the wgmma template at stride 1, each block over
    the 4 taps of its phase (weight panels of 4 CK rows)."""
    assert key[:3] == (1, 0, 0) and upconv.UP_BUILT[key][0] == conv.WGMMA
    _check_wgmma_tile(1, upconv.UP_BUILT[key][1:], taps=4)


@pytest.mark.parametrize("key", sorted(upconv.UB_BUILT))
def test_every_ub_tile_fits_an_sm(key):
    """Kernel UB's lines: the wgmma template at stride 2, each block over
    the 16 taps of the 4x4 window (weight panels of 16 CK rows)."""
    assert key[:3] == (2, 0, 0) and upconv.UB_BUILT[key][0] == conv.WGMMA
    _check_wgmma_tile(2, upconv.UB_BUILT[key][1:], taps=16)


@pytest.mark.parametrize("key", sorted(conv_tiles.CANDIDATES))
def test_every_study_candidate_fits_an_sm(key):
    for tile in conv_tiles.CANDIDATES[key]:
        _check_tile(key[0], tile)


@pytest.mark.parametrize("key", sorted(conv_tiles.UB_CANDIDATES))
def test_every_ub_study_candidate_fits_an_sm(key):
    for tile in conv_tiles.UB_CANDIDATES[key]:
        assert tile[0] == conv.WGMMA
        _check_wgmma_tile(2, tile[1:], taps=16)


@pytest.mark.parametrize("key", [k for k in sorted(conv.CONV_BUILT) if k[1]])
def test_p_keeps_the_chunk_depth_of_c(key):
    """P and C at the same site sum in one order (split, chunk, tap,
    16-channel step): P takes C's whole line (its tile, chunk depth CK and
    so its split plan), so P equals C on the prologue applied beforehand
    bit for bit (chip_smoke.py's P_VS_C_RTOL check)."""
    c_key = key[:1] + (0,) + key[2:]
    assert conv.CONV_BUILT[key] == conv.CONV_BUILT[c_key]


# (prologue, Cin, Cout, W) of C and P at the 512 px UNet's and VAE's conv
# sites, the conv's input gradient and a 256 px image's 4x4 mid block
SITES = [(False, 4, 320, 64), (False, 320, 320, 64), (False, 960, 320, 64),
         (False, 320, 960, 64), (False, 640, 640, 32), (False, 1280, 1280, 16),
         (False, 1280, 1280, 8), (False, 2560, 1280, 8), (False, 320, 4, 64),
         (False, 1280, 1280, 4), (False, 3, 128, 512), (False, 128, 3, 512),
         (False, 256, 128, 512), (False, 512, 512, 64), (False, 512, 8, 64),
         (True, 320, 320, 64), (True, 960, 320, 64), (True, 1280, 1280, 16),
         (True, 2560, 1280, 8), (True, 128, 128, 512), (True, 512, 512, 128)]


@pytest.mark.parametrize("pro, cin, cout, w", SITES)
def test_conv_tile_choice_at_the_sites_is_built(pro, cin, cout, w):
    key = conv.tile_key(1, pro, cin, cout, w)
    coutc = (0 if cout <= 16 else 2 if cin % 8 == 0 and cout % 128 else 1)
    assert key == (1, int(pro), int(cin % 8 != 0), coutc,
                   0 if w <= 8 else 1 if w <= 16 else 2)
    assert conv.conv_tile(pro, cin, cout, w) == conv.CONV_BUILT[key]
    # the wgmma template wherever Cin % 8 == 0 and Cout > 16, mma.sync at
    # the conv_in and conv_out keys
    fam = conv.WGMMA if cin % 8 == 0 and cout > 16 else conv.MMA
    assert conv.CONV_BUILT[key][0] == fam


# (H, W, Cin, Cout, pad) of D at the UNet's and the VAE encoder's sites
DOWN_SITES = [(64, 64, 320, 320, (1, 1, 1, 1)), (32, 32, 640, 640, (1, 1, 1, 1)),
              (16, 16, 1280, 1280, (1, 1, 1, 1)),
              (512, 512, 128, 128, (0, 1, 0, 1)),
              (256, 256, 256, 256, (0, 1, 0, 1)),
              (128, 128, 512, 512, (0, 1, 0, 1))]


@pytest.mark.parametrize("h, w, cin, cout, pad", DOWN_SITES)
def test_down_tile_choice_at_the_sites_is_built(h, w, cin, cout, pad):
    wo = downconv.out_size(h, w, pad)[1]
    assert wo == w // 2
    key = conv.tile_key(2, False, cin, cout, wo)
    assert downconv.down_tile(cin, cout, wo) == downconv.DOWN_BUILT[key]


@pytest.mark.parametrize("call", [
    lambda: conv.conv_tile(True, 3, 320, 64),    # P on a 3-channel input
    lambda: conv.conv_tile(True, 320, 4, 64),    # P with a narrow Cout
    lambda: downconv.down_tile(4, 320, 32),      # D on a 4-channel input
    lambda: downconv.down_tile(320, 8, 32),      # D with a narrow Cout
    lambda: conv.conv_tile(False, 320, 20, 64),  # wgmma: Cout % 8 != 0
    lambda: conv.pick_tile(conv.CONV_BUILT, (3, 0, 0, 1, 2)),
    lambda: upconv.up_tile(4, 320, 32),          # U on a 4-channel input
    lambda: upconv.up_tile(16, 20, 8),           # U: Cout % 8 != 0
    lambda: upconv.up_tile(320, 8, 32),          # U with a narrow Cout
    lambda: upconv.dx_tile(4, 320, 32),          # UB on a 4-channel g
    lambda: upconv.dx_tile(16, 20, 8),           # UB: Cout % 8 != 0
    lambda: upconv.dx_tile(320, 8, 32)])         # UB with a narrow Cout
def test_tile_choice_raises_for_an_unbuilt_key(call):
    with pytest.raises(ValueError, match="no conv kernel built"):
        call()


@pytest.mark.parametrize("key", sorted(conv_tiles.CANDIDATES))
def test_tile_study_rewrites_only_the_built_lines(key):
    name = conv_tiles.SOURCES[key[0]]
    src = (_build.CSRC / name).read_text()
    tile = conv_tiles.CANDIDATES[key][0]
    new = conv_tiles.candidate_source(key, tile)
    assert _built_lines(new) == [key + tuple(tile)]
    strip = re.compile(r"^\s*SG_BUILT\(\d[^)]*\)\s*\n", re.M)
    assert strip.sub("", new) == strip.sub("", src)


@pytest.mark.parametrize("key", sorted(conv_tiles.UB_CANDIDATES))
def test_ub_study_rewrites_only_the_built_lines(key):
    name = conv_tiles.UB_SOURCE
    src = (_build.CSRC / name).read_text()
    tile = conv_tiles.UB_CANDIDATES[key][0]
    new = conv_tiles.candidate_source(key, tile, name)
    assert _built_lines(new) == [key + tuple(tile)]
    strip = re.compile(r"^\s*SG_BUILT\(\d[^)]*\)\s*\n", re.M)
    assert strip.sub("", new) == strip.sub("", src)


def test_tile_study_covers_every_key_of_its_shapes():
    for name in conv_tiles.SHAPES:
        key = conv_tiles.shape_key(name)
        if conv_tiles.SHAPES[name][0] == "UB":
            built, cands = upconv.UB_BUILT, conv_tiles.UB_CANDIDATES
            assert conv_tiles.shape_source(name) == "upconv_dx3x3.cu"
        else:
            built = conv.CONV_BUILT if key[0] == 1 else downconv.DOWN_BUILT
            cands = conv_tiles.CANDIDATES
        assert key in built and key in cands
        # the built tile is among the candidates it was chosen from
        assert built[key] in cands[key]
        assert conv_tiles.shape_candidates(name) == cands[key]


def test_tile_study_runs_the_plain_path_on_the_cpu(capsys):
    shapes = [("tiny_c", "C", 1, 8, 8, 16, 24, False, True, None),
              ("tiny_p", "P", 2, 6, 10, 16, 16, True, True, None),
              ("tiny_d", "D", 1, 9, 7, 16, 24, False, False, (0, 1, 0, 1)),
              ("tiny_ub", "UB", 2, 3, 5, 16, 24, False, False, None)]
    conv_tiles.main(device="cpu", shapes=shapes, iters=1)
    out = capsys.readouterr().out
    for name, *_ in shapes:
        for row in ("plain (cpu)", "built"):
            line = next(x for x in out.splitlines()
                        if x.startswith(name) and row in x)
            assert "[cpu host clock]" in line
            # the wrapper's CPU path is the plain version: same result
            err = float(re.search(r"maxerr (\S+)", line).group(1))
            assert err < 0.1
    assert "FAILED" not in out


# (prologue, B, H, W, Cin, Cout) of C and P at chip_smoke.py's kernel sites:
# the UNet's and the VAE's at 512 px, the input gradient, the tensor-
# parallel shards, the ragged P case and the UNet's 32-column level
SMOKE_SITES = sorted({(k == "P", b, h, w, cin, cout)
                      for k, b, h, w, cin, cout, *_ in
                      conv_tiles.SHAPES.values() if k in ("C", "P")} | {
    (False, 3, 64, 64, 320, 160), (False, 3, 64, 64, 160, 320),
    (False, 3, 64, 64, 320, 80), (False, 3, 64, 64, 80, 320),
    (True, 3, 64, 64, 160, 320), (True, 3, 64, 64, 80, 320),
    (True, 2, 40, 24, 320, 320), (False, 3, 32, 32, 640, 640)})


@pytest.mark.parametrize("pro, b, h, w, cin, cout", SMOKE_SITES)
def test_split_plan_at_the_smoke_sites(pro, b, h, w, cin, cout):
    """The split count and the workspace that the wrapper allocates: one
    run where the batch-3 grid gives half the SMs a block, else enough
    runs of two chunks or more to fill them."""
    line = conv.conv_tile(pro, cin, cout, w)
    splits = conv.conv_splits(pro, cin, cout, h, w)
    shape = conv.workspace_shape(pro, b, h, w, cin, cout)
    if line[0] == conv.MMA:
        assert splits == 1 and shape is None
        return
    _, th, tw, ib, _, _, bn, ck, _ = line
    nc = math.ceil(cin / ck)
    blocks = (math.ceil(conv.PLAN_BATCH / ib) * math.ceil(h / th)
              * math.ceil(w / tw) * math.ceil(cout / bn))
    if blocks >= conv.SMS // 2:
        assert splits == 1 and shape is None
        return
    assert 1 <= splits <= max(1, nc // 2)
    assert blocks * splits >= conv.SMS or splits == max(1, nc // 2)
    if splits > 1:
        assert shape == (splits, b * h * w, cout)
        # the fp32 partials stay within L2's 50 MB at every smoke site
        assert 4 * math.prod(shape) <= 50e6
    # P takes C's line, so both plan alike (P_VS_C_RTOL)
    assert conv.conv_splits(not pro, cin, cout, h, w) == splits


def test_split_plan_at_the_few_pixel_sites():
    """The 16- and 8-column sites at 1280-2560 channels split their
    reduction (else 30 and 10 blocks at batch 3); the 64- and 512-column
    ones do not."""
    for cin, cout, hw in ((1280, 1280, 16), (1280, 1280, 8),
                          (2560, 1280, 8)):
        for pro in (False, True):
            assert conv.conv_splits(pro, cin, cout, hw, hw) > 1
    for cin, cout in ((960, 320), (320, 320), (320, 960)):
        assert conv.conv_splits(False, cin, cout, 64, 64) == 1
    assert conv.conv_splits(False, 256, 128, 512, 512) == 1


@pytest.mark.parametrize("pro, b, h, w, cin, cout", SMOKE_SITES)
def test_tile_and_split_ignore_the_batch(pro, b, h, w, cin, cout):
    """Neither the key, the line nor the split plan sees the batch: every
    batch size sums each output in one order (the smoke's batch-slice and
    batch-dependence checks)."""
    line = conv.conv_tile(pro, cin, cout, w)
    splits = conv.conv_splits(pro, cin, cout, h, w)
    for bb in (1, 2, 3, 4, 6):
        shape = conv.workspace_shape(pro, bb, h, w, cin, cout)
        assert (1 if shape is None else shape[0]) == splits
        assert shape is None or shape[1] == bb * h * w
    assert conv.conv_tile(pro, cin, cout, w) == line


@pytest.mark.parametrize("h, w, cin, cout, pad", DOWN_SITES)
def test_down_split_plan_ignores_the_batch(h, w, cin, cout, pad):
    """D's line and split plan depend on the output's shape, Cin and Cout
    alone (C's split_count on D's line): the few-pixel UNet sites split
    their reduction, the wide sites do not, and every batch takes the
    same plan, so each output sums in one order (the smoke's batch
    checks)."""
    ho, wo = downconv.out_size(h, w, pad)
    line = downconv.down_tile(cin, cout, wo)
    splits = downconv.down_splits(cin, cout, ho, wo)
    assert splits == conv.split_count(line, cin, cout, ho, wo)
    assert (splits > 1) == (wo <= 16 or (wo == 32 and cout == 320))
    for bb in (1, 3, 4, 16):
        shape = conv.workspace_shape(False, bb, ho, wo, cin, cout, line)
        assert (1 if shape is None else shape[0]) == splits
        assert shape is None or shape == (splits, bb * ho * wo, cout)
    assert downconv.down_tile(cin, cout, wo) == line


# (H, W, pad) of D's slab check: the two paddings, an odd and a one-column
# width, an odd height, and a left pad of 2
SLAB_CASES = [(8, 8, (1, 1, 1, 1)), (8, 8, (0, 1, 0, 1)),
              (7, 9, (1, 1, 1, 1)), (9, 7, (0, 1, 0, 1)),
              (5, 1, (1, 1, 1, 1)), (6, 10, (2, 0, 2, 1))]


@pytest.mark.parametrize("h, w, pad", SLAB_CASES)
def test_stride2_planes_give_the_plain_taps(h, w, pad):
    """D's slab arithmetic (`plane_taps`: tap dx of output column ox in
    plane (dx + pl % 2) % 2 at half-column ox + (dx + pl % 2) // 2 -
    ceil(pl / 2)) gathers each tap from x's even and odd column planes,
    with a coordinate outside a plane or the image reading 0 as TMA's
    fill does; the sum over taps equals downconv3x3_plain."""
    rs = np.random.RandomState(h * 100 + w)
    b, cin, cout = 2, 8, 16
    x = torch.tensor(rs.randn(b, h, w, cin), dtype=torch.float32)
    w9 = torch.tensor(rs.randn(9, cin, cout), dtype=torch.float32)
    bias = torch.tensor(rs.randn(cout), dtype=torch.float32)
    ho, wo = downconv.out_size(h, w, pad)
    pt, pl = pad[0], pad[2]
    planes = (x[:, :, 0::2], x[:, :, 1::2])
    taps = downconv.plane_taps(wo, pl)
    out = torch.zeros(b, ho, wo, cout) + bias
    for oy in range(ho):
        for ox in range(wo):
            for dy in range(3):
                row = 2 * oy + dy - pt
                for dx in range(3):
                    plane, hc = taps[ox, dx]
                    # the plane holds input column 2 hc + plane
                    assert 2 * hc + plane == 2 * ox + dx - pl
                    p = planes[plane]
                    if 0 <= row < h and 0 <= hc < p.shape[2]:
                        out[:, oy, ox] += p[:, row, hc] @ w9[3 * dy + dx]
    ref = downconv.downconv3x3_plain(x, w9, bias, pad)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-5)


# (B, H, W, Cin, Cout) of UB's output and cotangent channels at the
# training path's three up blocks, a ragged and a one-column source
UB_SITES = [(4, 8, 8, 1280, 1280), (4, 16, 16, 1280, 1280),
            (4, 32, 32, 640, 640), (2, 5, 6, 96, 96), (2, 7, 1, 64, 64)]


@pytest.mark.parametrize("b, h, w, cin, cout", UB_SITES)
def test_ub_tile_and_split_ignore_the_batch(b, h, w, cin, cout):
    """UB's line and split plan depend on its output's shape, Cin and Cout
    alone (C's split_count on UB's line): a site whose batch-3 grid gives
    fewer than half the SMs a block splits its 16 Cin reduction; every
    batch takes the same plan."""
    key = conv.tile_key(2, False, cin, cout, w)
    line = upconv.dx_tile(cin, cout, w)
    assert line == upconv.UB_BUILT[key]
    splits = upconv.dx_splits(cin, cout, h, w)
    assert splits == conv.split_count(line, cin, cout, h, w)
    _, th, tw, ib, _, _, bn, _, _ = line
    blocks = (math.ceil(conv.PLAN_BATCH / ib) * math.ceil(h / th)
              * math.ceil(w / tw) * math.ceil(cout / bn))
    assert (splits > 1) == (blocks < conv.SMS // 2)
    assert 1 <= splits <= max(1, math.ceil(cin / line[7]) // 2)
    for bb in (1, 2, 3, 4, 6):
        assert upconv.dx_tile(cin, cout, w) == line
        assert upconv.dx_splits(cin, cout, h, w) == splits


@pytest.mark.parametrize("h, w", [(8, 8), (5, 6), (7, 1), (1, 3)])
def test_ub_window_planes_give_the_plain_taps(h, w):
    """UB's slab arithmetic (csrc/conv_wgmma.cuh's tap_row in mode
    PHASES_DX): tap (ty, tx) of output pixel (r, s) reads the cotangent's
    row 2r - 1 + ty and column 2s - 1 + tx = 2 * half-column + plane, plane
    (tx + 1) % 2 at half-column s - 1 + (tx + 1) // 2, a coordinate outside
    g reading 0 as TMA's fill does; gathered so through `dx_weight`'s
    packing, the sum equals upconv3x3_dx_plain."""
    rs = np.random.RandomState(h * 10 + w)
    b, cin, cout = 2, 8, 16  # U's Cin and Cout: g has Cout channels
    g = torch.tensor(rs.randn(b, 2 * h, 2 * w, cout), dtype=torch.float32)
    w16 = torch.tensor(rs.randn(16, cin, cout), dtype=torch.float32)
    k16 = upconv.dx_weight(w16)
    assert k16.shape == (16, cout, cin) and k16.is_contiguous()
    planes = (g[:, :, 0::2], g[:, :, 1::2])
    out = torch.zeros(b, h, w, cin)
    for r in range(h):
        for s_ in range(w):
            for ty in range(4):
                row = 2 * r - 1 + ty
                for tx in range(4):
                    plane, hc = (tx + 1) % 2, s_ - 1 + (tx + 1) // 2
                    assert 2 * hc + plane == 2 * s_ - 1 + tx
                    if 0 <= row < 2 * h and 0 <= hc < w:
                        out[:, r, s_] += (planes[plane][:, row, hc]
                                          @ k16[4 * ty + tx])
    ref = upconv.upconv3x3_dx_plain(g, w16)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-5)
