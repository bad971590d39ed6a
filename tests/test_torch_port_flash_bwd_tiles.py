"""The tiles of kernels DQ and DKV (csrc/flash_bwd.cu), without a card: the
Python table of built instantiations against the source's SG_BUILT lines,
the wrapper's choice at every UNet backward shape, and the tile study's
rewrite of the source. The kernels themselves run only on the card
(chip_smoke.py)."""
import re
import subprocess
import sys

import pytest
import torch

from storygen_tpu_torch.ops import _build, flash_attention as fa
from storygen_tpu_torch.studies import common, flash_bwd_tiles

KINDS = {"kDq": "dq", "kDkv": "dkv"}
# the UNet's backward sites: (head dim, Sq, Skv, refs or None); attn3's
# spans of 4096 / 1024 / 256 / 64 rows at 512 px, 16 at the mid block of a
# 256 px image and 144 at that of a 768 px one, attn2's 77 text tokens
SITES = [(40, 4096, 4096, None), (40, 4096, 12288, 3), (40, 4096, 77, None),
         (80, 1024, 1024, None), (80, 1024, 3072, 3), (80, 1024, 77, None),
         (160, 256, 256, None), (160, 256, 768, 3), (160, 64, 64, None),
         (160, 64, 192, 3), (160, 16, 48, 3), (160, 144, 432, 3)]


def _built_lines(src: str):
    """(kernel, dp, masked, br, bc, stages, areg) of every SG_BUILT
    invocation after the macro's definition."""
    out = []
    for args in re.findall(r"^\s*SG_BUILT\((k\w+),([^)]*)\)\s*$", src, re.M):
        out.append((KINDS[args[0]], *(int(a) for a in args[1].split(","))))
    return out


def _smem(kernel: str, dp: int, tile) -> int:
    """Dynamic shared memory of an instantiation (flash_bwd.cu's Cfg): the
    block's two own tiles and the ring, rows at study_mma.cuh's pitch."""
    br, bc, stages, _ = tile

    def a128(x):
        return (x + 127) // 128 * 128

    row = dp * 2 if (dp * 2 // 16) % 2 else dp * 2 + 16
    stage = 2 * a128(bc * row) + (2 * a128(bc * 4) if kernel == "dkv" else 0)
    return 2 * a128(br * row) + stages * stage


def test_bwd_built_matches_the_cuda_source():
    lines = _built_lines((_build.CSRC / "flash_bwd.cu").read_text())
    table = {(k, dp, bool(m)): (br, bc, stages, bool(areg))
             for k, dp, m, br, bc, stages, areg in lines}
    assert len(table) == len(lines)  # one line per (kernel, dp, masked)
    assert table == fa.BWD_BUILT


@pytest.mark.parametrize("key", sorted(fa.BWD_BUILT))
def test_every_instantiation_fits_a_block(key):
    """Whole 16-row slices per warp, a ring of two stages or more, at most
    1024 threads, and the shared memory a block can have; every built tile
    is among the study's candidates, whose numbers chose it."""
    kernel, dp, _ = key
    tile = fa.BWD_BUILT[key]
    br, bc, stages, _ = tile
    assert br % 16 == 0 and bc % 16 == 0 and stages >= 2
    assert 32 * br // 16 <= 1024
    assert _smem(kernel, dp, tile) <= 232448
    assert tile in flash_bwd_tiles.CANDIDATES[(kernel, dp)]


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_tile_choice_at_the_unet_backward_shapes_is_built(kernel, site):
    d, sq, skv, nref = site
    masked = nref is not None
    tile = fa.bwd_tile(kernel, d, masked)
    assert tile == fa.BWD_BUILT[(kernel, (d + 15) // 16 * 16, masked)]
    if masked:
        span = fa.ref_span(skv, nref)
        # the K/V tile: DQ streams BC rows, a DKV block owns BR
        kv_tile = tile[1] if kernel == "dq" else tile[0]
        # the 512 px spans run the instantiation that tests one flag per
        # tile; only the mid block's 16 and 144 take the straddling one
        assert (span % kv_tile != 0) == (span in (16, 144))


@pytest.mark.parametrize("d", [64, 36, 8, 256])
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_bwd_tile_rejects_what_is_not_built(kernel, d):
    with pytest.raises(ValueError, match="no flash backward"):
        fa.bwd_tile(kernel, d, False)


def test_tile_study_rewrites_only_the_built_lines():
    src = (_build.CSRC / "flash_bwd.cu").read_text()
    new = flash_bwd_tiles.candidate_source("dkv", 160, (32, 16, 3, False))
    assert _built_lines(new) == [("dkv", 160, 0, 32, 16, 3, 0),
                                 ("dkv", 160, 1, 32, 16, 3, 0)]
    strip = re.compile(r"^\s*SG_BUILT\(k\w+,[^)]*\)\s*\n", re.M)
    assert strip.sub("", new) == strip.sub("", src)


@pytest.mark.parametrize("key", sorted(flash_bwd_tiles.CANDIDATES))
def test_tile_study_candidates_fit_a_block(key):
    kernel, dp = key
    for tile in flash_bwd_tiles.CANDIDATES[key]:
        br, bc, stages, _ = tile
        assert br % 16 == 0 and bc % 16 == 0 and stages >= 2
        assert _smem(kernel, dp, tile) <= 232448


_PTXAS = ("ptxas info    : Compiling entry function '_Z15flash_dq_kernel' "
          "for 'sm_90a'\n"
          "ptxas info    : Function properties for _Z15flash_dq_kernel\n"
          "    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill "
          "loads\n"
          "ptxas info    : Used 255 registers, 384 bytes cmem[0]\n"
          "ptxas info    : Compiling entry function '_Z16flash_dkv_kernel' "
          "for 'sm_90a'\n"
          "ptxas info    : Used 168 registers, 384 bytes cmem[0]\n")


def test_ptxas_summary_reads_registers_and_spills():
    assert common.ptxas_summary(_PTXAS) == [
        ("_Z15flash_dq_kernel", 255, 8, 12, 16),
        ("_Z16flash_dkv_kernel", 168, 0, 0, 0)]


def test_tile_study_builds_each_candidate_with_ptxas(tmp_path, monkeypatch,
                                                      capsys):
    """The studies' shared build: one nvcc per candidate for sm_90a with
    `-Xptxas -v`, the candidate's own source and library; its ptxas lines
    printed; a candidate whose build fails printed FAILED and left out.
    A stand-in nvcc records its arguments and prints ptxas lines."""
    fake = tmp_path / "nvcc.py"
    fake.write_text(
        "import sys, pathlib\n"
        "args = sys.argv[1:]\n"
        "pathlib.Path(args[args.index('-o') + 1]).write_text(' '.join(args))\n"
        "if 'BROKEN' in pathlib.Path(args[-1]).read_text():\n"
        "    print('error: BROKEN'); sys.exit(2)\n"
        f"print({_PTXAS!r})\n")
    popen = subprocess.Popen
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(subprocess, "Popen",
                        lambda cmd, **kw: popen([sys.executable, *cmd], **kw))
    libs = common.build_candidates(
        tmp_path / "out", {"a": ("flash_bwd_a", "// a\n"),
                           "b": ("flash_bwd_b", "// BROKEN\n")}, "flash_dq")
    assert list(libs) == ["a"]
    args = libs["a"].read_text().split()
    assert args[args.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert args[args.index("-Xptxas") + 1] == "-v" and "-shared" in args
    assert args[-1] == str(tmp_path / "out" / "flash_bwd_a.cu")
    assert libs["a"] == tmp_path / "out" / "libflash_bwd_a.so"
    out = capsys.readouterr().out
    assert "candidate flash_bwd_a: registers [255], stack/spill stores/loads" \
        " [(8, 12, 16)]" in out
    assert "candidate flash_bwd_b FAILED to build" in out and "BROKEN" in out


def test_tile_study_needs_the_card(monkeypatch):
    with pytest.raises(RuntimeError, match="card only"):
        flash_bwd_tiles.main(device="cpu", shapes=["attn1_mid"], iters=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_bwd_tiles.main(shapes=["attn1_mid"], iters=1)
