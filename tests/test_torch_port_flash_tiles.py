"""The tiles of kernels F, M and L (csrc/flash_fwd.cu), without a card:
the Python tables of built instantiations against the source's SG_BUILT
lines, the wrapper's choice at every UNet attention shape, and the tile
study's rewrite of the source. The kernels themselves run only on the card
(chip_smoke.py)."""
import re

import pytest
import torch

from storygen_tpu_torch.ops import _build, flash_attention as fa
from storygen_tpu_torch.studies import flash_fwd_tiles


KINDS = {"kFwd": "fwd", "kLse": "lse"}


def _built_lines(src: str, kind: str = "fwd"):
    """(dp, masked, bq, bk, halves, stages) of every SG_BUILT invocation of
    kernel `kind` ("fwd" for F and M, "lse" for L; not the macro's own
    definition)."""
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
    table = {(dp, bool(m)): (bq, bk, halves, stages)
             for dp, m, bq, bk, halves, stages in lines}
    assert len(table) == len(lines)  # one line per (dp, masked)
    assert table == fa.FWD_BUILT


@pytest.mark.parametrize("key", sorted(fa.FWD_BUILT))
def test_every_instantiation_tiles_kv_by_bk(key):
    bq, bk, halves, stages = fa.FWD_BUILT[key]
    assert bk == fa._BK
    assert bq % (16 * halves) == 0 and stages >= 2


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
    new = flash_fwd_tiles.candidate_source(48, 64, 2, 3)
    assert _built_lines(new) == [(48, 0, 64, fa._BK, 2, 3),
                                 (48, 1, 64, fa._BK, 2, 3)]
    assert _built_lines(new, "lse") == []
    strip = re.compile(r"^\s*SG_BUILT\(k\w+,[^)]*\)\s*\n", re.M)
    assert strip.sub("", new) == strip.sub("", src)


@pytest.mark.parametrize("dp", sorted(flash_fwd_tiles.CANDIDATES))
def test_tile_study_candidates_tile_kv_by_bk(dp):
    """Every candidate splits BQ into whole 16-row slices per warp, has a
    ring of two stages or more, and fits a block's shared memory (Q tile
    plus the ring, rows at study_mma.cuh's pitch)."""
    row = dp * 2 if (dp * 2 // 16) % 2 else dp * 2 + 16
    for bq, halves, stages in flash_fwd_tiles.CANDIDATES[dp]:
        assert bq % (16 * halves) == 0 and stages >= 2
        assert bq * row + stages * 2 * fa._BK * row <= 232448


def test_tile_study_needs_the_card(monkeypatch):
    with pytest.raises(RuntimeError, match="card only"):
        flash_fwd_tiles.main(device="cpu", shapes=["attn3_L3"], iters=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_fwd_tiles.main(shapes=["attn3_L3"], iters=1)


def test_lse_built_matches_the_cuda_source():
    lines = _built_lines((_build.CSRC / "flash_fwd.cu").read_text(), "lse")
    table = {(dp, bool(m)): (bq, bk, halves, stages)
             for dp, m, bq, bk, halves, stages in lines}
    assert len(table) == len(lines)  # one line per (dp, masked)
    assert table == fa.LSE_BUILT
    assert set(fa.LSE_BUILT) == set(fa.FWD_BUILT)


def _lse_bytes(dp, bq, stages):
    """Kernel L's shared memory: the Q tile and a ring of K tiles only."""
    row = dp * 2 if (dp * 2 // 16) % 2 else dp * 2 + 16
    return bq * row + stages * fa._BK * row


@pytest.mark.parametrize("key", sorted(fa.LSE_BUILT))
def test_every_lse_instantiation_fits_a_block(key):
    bq, bk, halves, stages = fa.LSE_BUILT[key]
    assert bk == fa._BK
    assert bq % (16 * halves) == 0 and stages >= 2
    assert _lse_bytes(key[0], bq, stages) <= 232448


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
    bq = tile[0]
    assert -(-sq // bq) * bq >= sq > (-(-sq // bq) - 1) * bq  # the grid rows
    if masked:  # the 512 px spans take the aligned instantiation
        span = fa.ref_span(skv, 3)
        assert (span % tile[1] == 0) == (sq not in (16, 144))


@pytest.mark.parametrize("d", [64, 36, 8, 256])
def test_lse_tile_rejects_what_is_not_built(d):
    with pytest.raises(ValueError, match="no flash logsumexp built"):
        fa.lse_tile(d, True)


def test_tile_study_rewrites_only_the_lse_lines():
    src = (_build.CSRC / "flash_fwd.cu").read_text()
    new = flash_fwd_tiles.candidate_source(80, 128, 2, 3, kind="lse")
    assert _built_lines(new, "lse") == [(80, 0, 128, fa._BK, 2, 3),
                                        (80, 1, 128, fa._BK, 2, 3)]
    assert _built_lines(new) == []
    strip = re.compile(r"^\s*SG_BUILT\(k\w+,[^)]*\)\s*\n", re.M)
    assert strip.sub("", new) == strip.sub("", src)


@pytest.mark.parametrize("dp", sorted(flash_fwd_tiles.LSE_CANDIDATES))
def test_tile_study_lse_candidates_fit_a_block(dp):
    cands = flash_fwd_tiles.LSE_CANDIDATES[dp]
    for bq, halves, stages in cands:
        assert bq % (16 * halves) == 0 and stages >= 2
        assert _lse_bytes(dp, bq, stages) <= 232448
    # the built tile is among the candidates it was chosen from
    for masked in (False, True):
        bq, _, halves, stages = fa.LSE_BUILT[(dp, masked)]
        assert (bq, halves, stages) in cands
