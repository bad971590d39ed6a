"""The tiles of kernels F, M and L (csrc/flash_fwd.cu on
csrc/flash_wgmma.cuh), without a card: the Python tables of built
instantiations against the source's SG_BUILT lines, each line's shared
memory, TMA boxes and wgmma widths, the wrapper's choice at every UNet
attention shape, the host plan (the tensor maps of every operand the smoke
gives F, M and L, and the walk over the kept tiles), and the tile study's
rewrite of the source. The kernels themselves run only on the card
(chip_smoke.py)."""
import re

import pytest
import torch

from storygen_tpu_torch.ops import _build, flash_attention as fa
from storygen_tpu_torch.studies import flash_fwd_tiles
from tests.torch_port_util import View


KINDS = {"kFwd": "fwd", "kLse": "lse"}


def _built_lines(src: str, kind: str = "fwd"):
    """The integer arguments of every SG_BUILT invocation of kernel `kind`
    (not the macros' own definitions): "fwd" for F and M, (dp, masked,
    bq, bk, stages, panel columns, ping-pong); "lse" for L, (dp, masked,
    bq, bk, stages, panel columns)."""
    out = []
    for k, args in re.findall(r"^\s*SG_BUILT\((k\w+),([^)]*)\)\s*$", src,
                              re.M):
        if KINDS[k] == kind:
            out.append(tuple(int(a) for a in args.split(",")))
    return out


def test_fwd_built_matches_the_cuda_source():
    src = (_build.CSRC / "flash_fwd.cu").read_text()
    assert set(re.findall(r"^\s*SG_BUILT\((k\w+),", src, re.M)) == \
        set(KINDS)
    lines = _built_lines(src)
    table = {(dp, bool(m)): tuple(rest) for dp, m, *rest in lines}
    assert len(table) == len(lines)  # one line per (dp, masked)
    assert table == fa.FWD_BUILT


@pytest.mark.parametrize("key", sorted(fa.FWD_BUILT))
def test_every_instantiation_tiles_kv_by_bk(key):
    """Every line tiles kv by one of the wgmma template's BKs with 2 or 3
    consumer warpgroups (ping-pong between exactly two), Q and K in
    panels of 16, 32 or 64 columns; the forward has no other template."""
    bq, bk, stages, a, b = fa.FWD_BUILT[key]
    assert stages >= 2
    assert bk in fa.WG_BK and bq in (128, 192)
    assert a in (16, 32, 64) and b in (0, 1) and (not b or bq == 128)


# the UNet's head dims, unpadded
HEAD_DIM = {48: 40, 80: 80, 160: 160}


@pytest.mark.parametrize("key", sorted(fa.FWD_BUILT))
def test_every_fwd_line_fits_a_block_and_tma(key):
    """Each F / M line's shared memory (flash_wgmma.cuh's FwCfg::BYTES
    mirrored) fits a block's 232,448 bytes; a wgmma line's panels sit on
    the swizzles' 1024-byte period, its TMA boxes keep TMA's rules (each
    dimension <= 256, inner bytes a multiple of 16 and within the swizzle
    span) and its products' N are legal wgmma widths (a multiple of 8, <=
    256) at D = 40, 80, 160: Q K^T's BK and P V's padded head dim, which
    V's panels divide."""
    dp, _ = key
    line = fa.FWD_BUILT[key]
    bq, bk, stages, kpw, _ = line
    assert fa.fwd_smem_bytes(dp, line) <= 232448
    vpw = fa.v_panel(dp)
    for n in (bk, dp):
        assert n % 8 == 0 and n <= 256
    assert dp % vpw == 0 and dp % 16 == 0
    for rows, width in ((bq, kpw), (bk, kpw), (bk, vpw)):
        assert rows * 2 * width % 1024 == 0
        box = (width, 1, rows, 1)
        assert all(0 < x <= 256 for x in box)
        assert (2 * width) % 16 == 0 and 2 * width in (32, 64, 128)
    d = HEAD_DIM[dp]
    maps = fa.fwd_maps(View((3, 256, 8 * d)), View((3, 256, 8 * d)),
                       View((3, 256, 8 * d)), 8, line)
    assert maps["q"]["box"] == (kpw, 1, bq, 1)
    assert maps["v"]["box"] == (vpw, 1, bk, 1)


@pytest.mark.parametrize("sq", [4096, 1024, 256, 64, 1000])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [40, 80, 160])
def test_tile_choice_at_the_unet_shapes_is_built(d, masked, sq):
    tile = fa.fwd_tile(d, masked)
    assert tile in fa.FWD_BUILT.values()
    assert tile == fa.FWD_BUILT[(d + 15) // 16 * 16, masked]
    bq = tile[0]
    assert -(-sq // bq) * bq >= sq > (-(-sq // bq) - 1) * bq  # the grid rows


@pytest.mark.parametrize("d", [64, 36, 8, 256])
def test_fwd_tile_rejects_what_is_not_built(d):
    with pytest.raises(ValueError, match="no flash forward built"):
        fa.fwd_tile(d, False)


def test_tile_study_rewrites_only_the_built_lines():
    src = (_build.CSRC / "flash_fwd.cu").read_text()
    new = flash_fwd_tiles.candidate_source(48, 128, 64, 3, 16, 0)
    assert _built_lines(new) == [(48, 0, 128, 64, 3, 16, 0),
                                 (48, 1, 128, 64, 3, 16, 0)]
    pp = flash_fwd_tiles.candidate_source(160, 128, 128, 2, 32, 1)
    assert _built_lines(pp) == [(160, 0, 128, 128, 2, 32, 1),
                                (160, 1, 128, 128, 2, 32, 1)]
    assert _built_lines(new, "lse") == []
    strip = re.compile(r"^\s*SG_BUILT\(k\w+,[^)]*\)\s*\n", re.M)
    assert strip.sub("", new) == strip.sub("", src)


@pytest.mark.parametrize("dp", sorted(flash_fwd_tiles.CANDIDATES))
def test_tile_study_candidates_tile_kv_by_bk(dp):
    """Every candidate has a ring of two stages or more, fits a block's
    shared memory, takes 2-3 consumer warpgroups (ping-pong only with
    two) and a legal BK and panel width; the built line of each key is
    among them, and so is a line of each BK."""
    cands = flash_fwd_tiles.CANDIDATES[dp]
    for bq, bk, stages, a, b in cands:
        assert stages >= 2
        assert fa.fwd_smem_bytes(dp, (bq, bk, stages, a, b)) <= 232448
        assert bk in fa.WG_BK and bq in (128, 192) and a in (16, 32, 64)
        assert not b or bq == 128
    for masked in (False, True):
        assert fa.FWD_BUILT[(dp, masked)] in cands
    assert {c[1] for c in cands} == set(fa.WG_BK)


def test_tile_study_needs_the_card(monkeypatch):
    with pytest.raises(RuntimeError, match="card only"):
        flash_fwd_tiles.main(device="cpu", shapes=["attn3_L3"], iters=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_fwd_tiles.main(shapes=["attn3_L3"], iters=1)


def test_lse_built_matches_the_cuda_source():
    lines = _built_lines((_build.CSRC / "flash_fwd.cu").read_text(), "lse")
    table = {(dp, bool(m)): tuple(rest) for dp, m, *rest in lines}
    assert len(table) == len(lines)  # one line per (dp, masked)
    assert table == fa.LSE_BUILT
    assert set(fa.LSE_BUILT) == set(fa.FWD_BUILT)


def _check_lse_line(dp, line):
    """Kernel L's line at padded head dim dp: the Q panels and a ring of K
    stages only (FwCfg<..., false>::BYTES) within a block's shared memory;
    2-3 consumer warpgroups, whose two accumulator sets of BK / 2
    registers each fit the registers setmaxnreg gives them; panels on the
    swizzles' 1024-byte period, TMA boxes within TMA's rules and Q K^T's
    N a wgmma width of WgMmaSS."""
    bq, bk, stages, kpw = line
    assert stages >= 2 and bk in fa.WG_BK and bq in (128, 192)
    assert fa.fwd_smem_bytes(dp, line, v=False) <= 232448
    wgm = bq // 64
    regs = 512 // (wgm + 1) // 8 * 8
    consumer = min(240, (regs + (regs - 40) // wgm) // 8 * 8)
    assert consumer >= bk + 24  # s0 and s1, and some room
    assert kpw in (16, 32, 64)
    for rows in (bq, bk):
        assert rows * 2 * kpw % 1024 == 0 and 0 < rows <= 256
    assert f"struct WgMmaSS<{bk}>" in (_build.CSRC / "hopper.cuh").read_text()


@pytest.mark.parametrize("key", sorted(fa.LSE_BUILT))
def test_every_lse_instantiation_fits_a_block(key):
    _check_lse_line(key[0], fa.LSE_BUILT[key])


# (B, Sq, Skv, head dim, masked) of every attention site of the 512 px
# UNet's stage-2 backward (batch 4): attn1, attn2 (77 text tokens) and
# attn3 (3 refs under the keep mask) at each level and the mid block, and
# the mid block's attn3 at 256 and 768 px (spans of 16 and 144 tokens)
BWD_SITES = [(4, 4096, 4096, 40, False), (4, 4096, 77, 40, False),
             (4, 4096, 12288, 40, True), (4, 1024, 1024, 80, False),
             (4, 1024, 77, 80, False), (4, 1024, 3072, 80, True),
             (4, 256, 256, 160, False), (4, 256, 77, 160, False),
             (4, 256, 768, 160, True), (4, 64, 64, 160, False),
             (4, 64, 77, 160, False), (4, 64, 192, 160, True),
             (4, 16, 48, 160, True), (4, 144, 432, 160, True)]


@pytest.mark.parametrize("b, sq, skv, d, masked", BWD_SITES)
def test_lse_tile_choice_at_the_unet_backward_sites(b, sq, skv, d, masked):
    tile = fa.lse_tile(d, masked)
    assert tile == fa.LSE_BUILT[(d + 15) // 16 * 16, masked]
    bq, bk = tile[:2]
    assert -(-sq // bq) * bq >= sq > (-(-sq // bq) - 1) * bq  # the grid rows
    if masked:  # the STRADDLE kernel where BK does not divide the span
        span = fa.ref_span(skv, 3)
        assert (span % bk != 0) == (span in (16, 144)
                                    or (span, bk) == (64, 128))


@pytest.mark.parametrize("b, sq, skv, d",
                         [s[:4] for s in BWD_SITES if s[4]])
def test_fwd_masked_sites_straddle_where_bk_does_not_divide_the_span(
        b, sq, skv, d):
    """M's instantiation at each UNet attn3 site: the STRADDLE kernel
    exactly where the line's BK does not divide the span (16 and 144
    tokens, and the 512 px mid block's 64 under a 128-row tile)."""
    bk = fa.fwd_tile(d, True)[1]
    span = fa.ref_span(skv, 3)
    assert (span % bk != 0) == (span in (16, 144) or (span, bk) == (64, 128))


@pytest.mark.parametrize("d", [64, 36, 8, 256])
def test_lse_tile_rejects_what_is_not_built(d):
    with pytest.raises(ValueError, match="no flash logsumexp built"):
        fa.lse_tile(d, True)


def test_tile_study_rewrites_only_the_lse_lines():
    src = (_build.CSRC / "flash_fwd.cu").read_text()
    new = flash_fwd_tiles.candidate_source(80, 128, 64, 4, 64, kind="lse")
    assert _built_lines(new, "lse") == [(80, 0, 128, 64, 4, 64),
                                        (80, 1, 128, 64, 4, 64)]
    assert _built_lines(new) == []
    strip = re.compile(r"^\s*SG_BUILT\(k\w+,[^)]*\)\s*\n", re.M)
    assert strip.sub("", new) == strip.sub("", src)


@pytest.mark.parametrize("dp", sorted(flash_fwd_tiles.LSE_CANDIDATES))
def test_tile_study_lse_candidates_fit_a_block(dp):
    cands = flash_fwd_tiles.LSE_CANDIDATES[dp]
    for line in cands:
        _check_lse_line(dp, line)
    # the built tile is among the candidates it was chosen from
    for masked in (False, True):
        assert fa.LSE_BUILT[(dp, masked)] in cands


# every F / M operand of chip_smoke.py's kernels phase: (B, Sq, Skv, head
# dim, heads, k|v split view), its fwd list with the TP shards (4 and 2
# heads) and the split views
SMOKE_FWD = [(6, 4096, 4096, 40, 8, False), (3, 4096, 4096, 40, 8, False),
             (3, 4096, 12288, 40, 8, False), (3, 1024, 3072, 80, 8, False),
             (3, 256, 768, 160, 8, False), (6, 64, 64, 160, 8, False),
             (3, 4096, 77, 40, 8, False), (2, 1000, 333, 40, 8, False),
             (4, 4096, 12288, 40, 8, False), (4, 1024, 3072, 80, 8, False),
             (4, 256, 768, 160, 8, False), (4, 64, 192, 160, 8, False),
             (4, 16, 48, 160, 8, False), (4, 144, 432, 160, 8, False),
             (2, 256, 768, 80, 8, False), (3, 4096, 4096, 40, 4, False),
             (3, 4096, 4096, 40, 2, False), (3, 4096, 4096, 40, 8, True),
             (4, 1024, 3072, 80, 8, True), (3, 4096, 4096, 40, 1, False)]


def _element_offset(m, coord):
    """The byte offset a tensor map gives element (d, h, s, b)."""
    d, *rest = coord
    return 2 * d + sum(c * st for c, st in zip(rest, m["strides"]))


@pytest.mark.parametrize("b, sq, skv, d, heads, split", SMOKE_FWD)
@pytest.mark.parametrize("masked", [False, True])
def test_fwd_tensor_maps_at_the_smoke_shapes(b, sq, skv, d, heads, split,
                                             masked):
    """The tensor maps of q, k and v: (D, H, S, B) with the operand's own
    strides in bytes (a split view's row stride is 2 H D), each a positive
    multiple of 16 bytes, boxes within TMA's rules, and every element at
    the byte offset the tensor itself gives it: the map reads each head's
    D columns of each row and nothing of the next head's or batch row's
    (those fall outside dims 0 and 2 and read as zero)."""
    line = fa.fwd_tile(d, masked)
    hd = heads * d
    q = View((b, sq, hd))
    kv = (View((b, skv, hd), (skv * 2 * hd, 2 * hd, 1)) if split
          else View((b, skv, hd)))
    maps = fa.fwd_maps(q, kv, kv, heads, line)
    dp = (d + 15) // 16 * 16
    for name, t, rows, width in (("q", q, line[0], line[3]),
                                 ("k", kv, line[1], line[3]),
                                 ("v", kv, line[1], fa.v_panel(dp))):
        m = maps[name]
        s = t.shape[1]
        assert m["dims"] == (d, heads, s, b)
        assert m["box"] == (width, 1, rows, 1)
        assert m["swizzle"] == 2 * width
        assert all(x % 16 == 0 and x > 0 for x in m["strides"])
        for coord in [(0, 0, 0, 0), (d - 1, heads - 1, s - 1, b - 1),
                      (d // 2, heads // 2, s // 3, b // 2)]:
            dd, hh, ss, bb = coord
            want = 2 * (bb * t.stride(0) + ss * t.stride(1) + hh * d + dd)
            assert _element_offset(m, coord) == want
        # the panels cover the padded head dim: Q K^T's k steps, P V's N
        assert -(-dp // width) * width >= dp


def test_fwd_tensor_map_rejects_what_tma_cannot_read():
    line = fa.FWD_BUILT[(48, False)]
    with pytest.raises(ValueError, match="multiples of 16"):
        fa.fwd_maps(View((2, 64, 320)), View((2, 64, 320), (0, 320, 1)),
                    View((2, 64, 320)), 8, line)
    with pytest.raises(ValueError, match="contiguous"):
        fa.fwd_maps(View((2, 64, 320), (64 * 320, 320, 2)),
                    View((2, 64, 320)), View((2, 64, 320)), 8, line)


# (span, refs): the attn3 spans of the 512 px UNet's levels and mid block,
# and of the mid block at 256 and 768 px
SPANS = [(4096, 3), (1024, 3), (256, 3), (64, 3), (16, 3), (144, 3)]


@pytest.mark.parametrize("span, nref", SPANS)
@pytest.mark.parametrize("bk", sorted(fa.WG_BK))
def test_kept_tile_walk_covers_the_kept_rows(span, nref, bk):
    """M's (and masked L's) walk over the kept tiles, for every keep row
    the smoke and
    training draw (and one that keeps nothing): its tiles cover every kept
    kv row of keep_to_mask, and none lies wholly in dropped spans."""
    skv = span * nref
    rows = [[0, 0, 1], [0, 1, 1], [1, 1, 1], [1, 0, 0], [1, 0, 1],
            [0, 1, 0], [0, 0, 0]]
    keep = torch.tensor(rows, dtype=torch.bool)
    mask = fa.keep_to_mask(keep, skv)[:, 0, 0, :]
    for i, row in enumerate(rows):
        tiles = fa.kept_tiles(row, skv, bk)
        assert tiles == sorted(set(tiles))
        covered = torch.zeros(skv, dtype=torch.bool)
        for t in tiles:
            cols = mask[i, t * bk:min(t * bk + bk, skv)]
            assert bool(cols.any())  # not wholly in dropped spans
            covered[t * bk:min(t * bk + bk, skv)] = True
        assert bool((covered | ~mask[i]).all())  # every kept row is walked
        if not any(row):
            assert tiles == []


# every L operand of chip_smoke.py's kernels phase: (B, Sq, Skv, head dim,
# heads, k|v split view), its backward cases
SMOKE_LSE = [(4, 4096, 4096, 40, 8, False), (4, 4096, 12288, 40, 8, False),
             (4, 4096, 77, 40, 8, False), (4, 1024, 1024, 80, 8, False),
             (4, 1024, 3072, 80, 8, False), (4, 256, 768, 160, 8, False),
             (4, 64, 64, 160, 8, False), (4, 16, 48, 160, 8, False),
             (4, 144, 432, 160, 8, False), (2, 256, 768, 80, 8, False),
             (2, 1000, 333, 40, 8, False), (2, 1000, 333, 160, 8, False),
             (2, 999, 333, 40, 8, False), (4, 1024, 3072, 80, 8, True),
             (4, 4096, 4096, 40, 4, False), (4, 4096, 12288, 40, 4, False)]


@pytest.mark.parametrize("b, sq, skv, d, heads, split", SMOKE_LSE)
@pytest.mark.parametrize("masked", [False, True])
def test_lse_tensor_maps_at_the_smoke_shapes(b, sq, skv, d, heads, split,
                                             masked):
    """Kernel L's two tensor maps (lse_wg_launch: Q in boxes of BQ rows, K
    of BK, both in the line's panels) at the smoke's shapes: (D, H, S, B)
    with the operand's own strides, every element at the byte offset the
    tensor gives it, and no V map."""
    line = fa.lse_tile(d, masked)
    hd = heads * d
    q = View((b, sq, hd))
    k = (View((b, skv, hd), (skv * 2 * hd, 2 * hd, 1)) if split
         else View((b, skv, hd)))
    maps = fa.fwd_maps(q, k, None, heads, line)
    assert set(maps) == {"q", "k"}
    for name, t, rows in (("q", q, line[0]), ("k", k, line[1])):
        m = maps[name]
        assert m["dims"] == (d, heads, t.shape[1], b)
        assert m["box"] == (line[3], 1, rows, 1)
        for coord in [(0, 0, 0, 0), (d - 1, heads - 1, t.shape[1] - 1, b - 1)]:
            dd, hh, ss, bb = coord
            want = 2 * (bb * t.stride(0) + ss * t.stride(1) + hh * d + dd)
            assert _element_offset(m, coord) == want
