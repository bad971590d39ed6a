"""The tiles of kernels F and M (csrc/flash_fwd.cu), without a card: the
Python table of built instantiations against the source's SG_BUILT lines,
the wrapper's choice at every UNet attention shape, and the tile study's
rewrite of the source. The kernels themselves run only on the card
(chip_smoke.py)."""
import re

import pytest
import torch

from storygen_tpu_torch.ops import _build, flash_attention as fa
from storygen_tpu_torch.studies import flash_fwd_tiles


def _built_lines(src: str):
    """(dp, masked, bq, bk, halves, stages) of every SG_BUILT invocation
    after the exported launcher's head (not the macro's own definition)."""
    body = src[src.index('extern "C"'):]
    out = []
    for args in re.findall(r"^\s*SG_BUILT\(([^)]*)\)\s*$", body, re.M):
        if any(a.strip().endswith("_") for a in args.split(",")):
            continue
        out.append(tuple(int(a) for a in args.split(",")))
    return out


def test_fwd_built_matches_the_cuda_source():
    lines = _built_lines((_build.CSRC / "flash_fwd.cu").read_text())
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
    strip = re.compile(r"^\s*SG_BUILT\(\d[^)]*\)\s*\n", re.M)
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
