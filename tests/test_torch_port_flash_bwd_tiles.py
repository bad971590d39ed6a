"""The tiles of kernels DQ and DKV (csrc/flash_bwd.cu over
csrc/flash_bwd_wgmma.cuh's template), without a card: the Python table of
built instantiations against the source's SG_BUILT lines, each line's
shared memory, registers, TMA boxes and wgmma widths, the wrapper's
choice at every UNet backward shape, the host plan (the tensor maps of
every operand the smoke gives DQ and DKV, the choice between TMA and plain
loads for DKV's lse and delta, DQ's walk over the kept tiles and DKV's
dropped blocks), and the tile study's rewrite of the source. What the
kernel decides is read from its header (BwCfg's members and static
asserts, the launcher's tensor maps, the walk's expressions) and
evaluated here. The kernels themselves run only on the card
(chip_smoke.py)."""
import re
import subprocess
import sys

import pytest
import torch

from storygen_tpu_torch.ops import _build, flash_attention as fa
from storygen_tpu_torch.studies import common, flash_bwd_tiles
from tests.torch_port_util import View, c_eval, cuda_struct

KINDS = {"kDq": "dq", "kDkv": "dkv"}
WG_SRC = (_build.CSRC / "flash_bwd_wgmma.cuh").read_text()
HOPPER_SRC = (_build.CSRC / "hopper.cuh").read_text()
# the wgmma widths hopper.cuh instantiates: the logits' N (shared-memory
# A) and the gradients' N (register A)
WGMMA_SS_N = {int(n) for n in re.findall(r"^struct WgMmaSS<(\d+)>",
                                         HOPPER_SRC, re.M)}
WGMMA_N = {int(n) for n in re.findall(r"^struct WgMma<(\d+)>", HOPPER_SRC,
                                      re.M)}
# the UNet's backward sites: (head dim, Sq, Skv, refs or None); attn3's
# spans of 4096 / 1024 / 256 / 64 rows at 512 px, 16 at the mid block of a
# 256 px image and 144 at that of a 768 px one, attn2's 77 text tokens
SITES = [(40, 4096, 4096, None), (40, 4096, 12288, 3), (40, 4096, 77, None),
         (80, 1024, 1024, None), (80, 1024, 3072, 3), (80, 1024, 77, None),
         (160, 256, 256, None), (160, 256, 768, 3), (160, 64, 64, None),
         (160, 64, 192, 3), (160, 16, 48, 3), (160, 144, 432, 3)]
# a consumer thread's registers with one consumer warpgroup (no
# setmaxnreg, 256 threads a block); with two, BwCfg's CONSUMER_REGS. 24
# are left for addresses, counters and the exps' operands
ONE_GROUP_REGS = 255
HEADROOM = 24


def _built_lines(src: str):
    """(kernel, dp, masked, br, bc, stages, own panel columns, ping-pong)
    of every SG_BUILT invocation after the macro's definition."""
    out = []
    for args in re.findall(r"^\s*SG_BUILT\((k\w+),([^)]*)\)\s*$", src, re.M):
        out.append((KINDS[args[0]], *(int(a) for a in args[1].split(","))))
    return out


def _cfg(kernel: str, dp: int, line):
    """BwCfg's members and failing static asserts for a line."""
    br, bc, stages, apw, _ = line
    return cuda_struct(WG_SRC, "BwCfg", DKV=int(kernel == "dkv"), DP=dp,
                       WGM=br // 64, BN=bc, STAGES=stages, APW=apw)


def _held_floats(kernel: str, dp: int, line) -> int:
    """The values a consumer thread holds through its loop: the
    gradients' accumulators (DQ: dQ; DKV: dK and dV, dp / 2 each), the
    logits' and dP's (bc / 2 each) and the gradients' bf16 A fragments
    (bc / 16 k steps of 4 registers: dS; DKV also P^T)."""
    bc = line[1]
    grads = 1 if kernel == "dq" else 2
    return grads * dp // 2 + bc + grads * bc // 4


def _fits_a_block(kernel: str, dp: int, line) -> None:
    br, bc, stages, apw, pp = line
    assert br % 64 == 0 and pp in (0, 1) and (not pp or br == 128)
    cfg, failed = _cfg(kernel, dp, line)
    # shared memory, the register split, panels on the swizzle period,
    # the head dims, panel widths and N the template takes
    assert failed == []
    assert cfg["NT"] <= 1024
    regs = cfg["CONSUMER_REGS"] if br > 64 else ONE_GROUP_REGS
    assert _held_floats(kernel, dp, line) <= regs - HEADROOM
    # wgmma widths: the logits' N = BC, the gradients' N = dp, which the
    # streamed panels divide
    assert bc in WGMMA_SS_N and dp in WGMMA_N and dp % cfg["SPW"] == 0
    for rows, width in ((br, apw), (bc, cfg["SPW"])):
        assert 0 < rows <= 256 and 2 * width in (32, 64, 128)


def test_bwd_built_matches_the_cuda_source():
    lines = _built_lines((_build.CSRC / "flash_bwd.cu").read_text())
    table = {(k, dp, bool(m)): tuple(rest) for k, dp, m, *rest in lines}
    assert len(table) == len(lines)  # one line per (kernel, dp, masked)
    assert table == fa.BWD_BUILT
    # every key has a line: both kernels at the UNet's padded head dims,
    # unmasked and masked
    assert set(table) == {(k, dp, m) for k in ("dq", "dkv")
                          for dp in (48, 80, 160) for m in (False, True)}


@pytest.mark.parametrize("key", sorted(fa.BWD_BUILT))
def test_every_instantiation_fits_a_block(key):
    """A block's shared memory, its consumer threads' registers, its TMA
    boxes and wgmma widths. Every built line is among the study's
    candidates, whose numbers chose it."""
    kernel, dp, _ = key
    line = fa.BWD_BUILT[key]
    _fits_a_block(kernel, dp, line)
    assert line in flash_bwd_tiles.CANDIDATES[(kernel, dp)]


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
    new = flash_bwd_tiles.candidate_source("dkv", 160, (64, 32, 3, 32, 0))
    assert _built_lines(new) == [("dkv", 160, 0, 64, 32, 3, 32, 0),
                                 ("dkv", 160, 1, 64, 32, 3, 32, 0)]
    two = flash_bwd_tiles.candidate_source("dq", 48, (128, 128, 2, 64, 1))
    assert _built_lines(two) == [("dq", 48, 0, 128, 128, 2, 64, 1),
                                 ("dq", 48, 1, 128, 128, 2, 64, 1)]
    strip = re.compile(r"^\s*SG_BUILT\(k\w+,[^)]*\)\s*\n", re.M)
    assert strip.sub("", new) == strip.sub("", src)
    assert strip.sub("", two) == strip.sub("", src)


@pytest.mark.parametrize("key", sorted(flash_bwd_tiles.CANDIDATES))
def test_tile_study_candidates_fit_a_block(key):
    """Every candidate fits a block, none is listed twice, and each key's
    study holds its built lines."""
    kernel, dp = key
    cands = flash_bwd_tiles.CANDIDATES[key]
    for line in cands:
        _fits_a_block(kernel, dp, line)
    assert len(set(cands)) == len(cands)
    for masked in (False, True):
        assert fa.BWD_BUILT[(kernel, dp, masked)] in cands


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


# every DQ / DKV operand of chip_smoke.py's kernels phase: (B, Sq, Skv,
# head dim, heads, k|v split view), its backward list with the TP = 2
# shard, the ragged and odd shapes, and a k|v split view
SMOKE_BWD = [(4, 4096, 4096, 40, 8, False), (4, 4096, 12288, 40, 8, False),
             (4, 4096, 77, 40, 8, False), (4, 1024, 1024, 80, 8, False),
             (4, 1024, 3072, 80, 8, False), (4, 256, 768, 160, 8, False),
             (4, 64, 64, 160, 8, False), (4, 16, 48, 160, 8, False),
             (4, 144, 432, 160, 8, False), (2, 256, 768, 80, 8, False),
             (2, 1000, 333, 40, 8, False), (2, 1000, 333, 160, 8, False),
             (2, 999, 333, 40, 8, False), (4, 4096, 4096, 40, 4, False),
             (4, 4096, 12288, 40, 4, False), (4, 1024, 3072, 80, 8, True)]


def _element_offset(m, coord):
    """The byte offset a tensor map gives element (d, h, s, b)."""
    d, *rest = coord
    return 2 * d + sum(c * st for c, st in zip(rest, m["strides"]))


def _encoded_operands(kernel: str) -> dict:
    """name -> (panel columns, box rows), as the symbols of the launcher
    (flash_bwd_wg_launch), of the map it encodes for each bf16 operand."""
    body = WG_SRC[WG_SRC.index("cudaError_t flash_bwd_wg_launch("):]
    dkv, dq = body[:body.index("if (!ok)")].split("} else {", 1)
    calls = re.findall(r"encode_operand\(&t\w, (\w+),[^;]*?,\s*(APW|C::SPW),"
                       r"\s*(C::BM|BN)\)", dkv if kernel == "dkv" else dq)
    return {name: (width, rows) for name, width, rows in calls}


@pytest.mark.parametrize("b, sq, skv, d, heads, split", SMOKE_BWD)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_bwd_tensor_maps_at_the_smoke_shapes(kernel, b, sq, skv, d, heads,
                                             split, masked):
    """The tensor maps the launcher encodes for q, k, v and dout: (D, H,
    S, B) with the operand's own strides in bytes (a split view's row
    stride is 2 H D), each a positive multiple of 16 bytes, every element
    at the byte offset the tensor itself gives it; the block's own
    operands (DQ: q, dout; DKV: k, v) in boxes of BR rows and the line's
    panel columns, the streamed ones in boxes of BC rows and SPW columns,
    whose panels cover the padded head dim that both products read."""
    line = fa.bwd_tile(kernel, d, masked)
    hd = heads * d
    q, dout = View((b, sq, hd)), View((b, sq, hd))
    kv = (View((b, skv, hd), (skv * 2 * hd, 2 * hd, 1)) if split
          else View((b, skv, hd)))
    dp = (d + 15) // 16 * 16
    br, bc, _, apw, _ = line
    cfg, _ = _cfg(kernel, dp, line)
    symbols = {"APW": apw, "C::SPW": cfg["SPW"], "C::BM": cfg["BM"],
               "BN": bc}
    encoded = _encoded_operands(kernel)
    assert sorted(encoded) == ["dout", "k", "q", "v"]
    own = ("q", "dout") if kernel == "dq" else ("k", "v")
    for name, t in (("q", q), ("k", kv), ("v", kv), ("dout", dout)):
        width, rows = (symbols[x] for x in encoded[name])
        assert (rows, width) == ((br, apw) if name in own
                                 else (bc, cfg["SPW"]))
        m = fa.operand_map(t.shape, t.stride(), heads, width, rows)
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
        assert -(-dp // width) * width >= dp
        if name not in own:  # read N-major too: whole panels of dp
            assert dp % width == 0


def _scalars_by_tma(sq: int, lse: int, delta: int) -> bool:
    """The launcher's choice (scalars_by_tma) for lse and delta at the
    addresses `lse`, `delta`."""
    expr = re.search(r"inline bool scalars_by_tma\([^)]*\) \{\s*return "
                     r"(.*?);", WG_SRC, re.S).group(1)
    return bool(c_eval(expr, Sq=sq, lse=lse, delta=delta))


def _scalar_map(bh: int, sq: int, rows: int) -> dict:
    """The dims, byte strides and box that encode_scalars gives a (B H,
    Sq) fp32 row map in boxes of `rows` entries."""
    body = WG_SRC[WG_SRC.index("inline bool encode_scalars("):]

    def field(name):
        init = re.search(name + r"\[\d\] = \{(.*?)\};", body).group(1)
        return tuple(c_eval(x, Sq=sq, BH=bh, rows=rows)
                     for x in init.split(","))
    return {"dims": field("dim"), "strides": field("str"),
            "box": field("box")}


@pytest.mark.parametrize("sq, by_tma", [(4096, True), (1000, True),
                                        (333, False), (999, False),
                                        (16, True), (144, True), (77, False),
                                        (1002, False)])
def test_dkv_reads_lse_and_delta_by_tma_where_rows_align(sq, by_tma):
    """DKV's lse and delta come by TMA where every (B, H) row of Sq fp32
    starts on 16 bytes (Sq % 4 == 0, the tensors 16-byte aligned), else by
    the producer's plain loads; never padded by a copy in the wrapper.
    Where TMA reads them, the map (one box of BC entries a Q tile) keeps
    TMA's rules."""
    assert _scalars_by_tma(sq, 0, 256) == by_tma
    assert not _scalars_by_tma(sq, 8, 256)  # a start off 16 bytes
    assert not _scalars_by_tma(sq, 0, 260)
    # the launcher encodes both maps with the line's BC entries a box
    assert re.findall(r"encode_scalars\(&t\w, a\.(\w+), B \* a\.H, a\.Sq, "
                      r"(\w+)\)", WG_SRC) == [("lse", "BN"), ("delta", "BN")]
    bc = fa.bwd_tile("dkv", 40, False)[1]
    m = _scalar_map(32, sq, bc)
    assert m == {"dims": (sq, 32), "strides": (4 * sq,), "box": (bc, 1)}
    assert (m["strides"][0] % 16 == 0) == by_tma
    assert (4 * bc) % 16 == 0 and bc <= 256


# (span, refs): attn3's spans at the 512 px UNet's first level and the
# mid block's at 256 and 768 px
BWD_SPANS = [(4096, 3), (16, 3), (144, 3), (64, 3)]
KEEP_ROWS = [[0, 0, 1], [0, 1, 1], [1, 1, 1], [1, 0, 0], [1, 0, 1],
             [0, 1, 0], [0, 0, 0]]


def _walk_expr(pattern: str) -> str:
    return re.search(pattern, WG_SRC, re.S).group(1)


def _dq_walk(keep_row, skv: int, bc: int) -> list:
    """The K/V tiles of BC rows that DQ walks for a batch row whose keep
    flags are `keep_row`: the kernel's `kept` over its tps, first_span
    and last_span; the STRADDLE instantiation where BC does not divide
    the span (flash_bwd.cu's dispatch)."""
    span = fa.ref_span(skv, len(keep_row))
    straddle = int(span % bc != 0)
    names = dict(MASKED=1, STRADDLE=straddle, span=span, BN=bc, Skv=skv)
    tps = c_eval(_walk_expr(r"const int tps = (.*?);"), **names)
    first = _walk_expr(r"auto first_span = \[&\]\(int t\) \{\s*return "
                       r"(.*?);")
    last = _walk_expr(r"auto last_span = \[&\]\(int t\) \{\s*return "
                      r"(.*?);")

    def kept(t):
        if not straddle:
            return keep_row[t // tps] != 0
        lo, hi = c_eval(first, t=t, **names), c_eval(last, t=t, **names)
        assert 0 <= lo <= hi < len(keep_row)
        return any(keep_row[lo:hi + 1])
    return [t for t in range(-(-skv // bc)) if kept(t)]


def _dkv_block_live(keep_row, skv: int, br: int, block: int) -> bool:
    """The kernel's `live` for DKV block `block` of BR kv rows: one of
    the spans span0 .. span1 of its first and last row is kept."""
    names = dict(DKV=1, MASKED=1, m0=block * br, BM=br, Skv=skv,
                 span=fa.ref_span(skv, len(keep_row)))
    span0 = c_eval(_walk_expr(r"const int span0 = (.*?);"), **names)
    span1 = c_eval(_walk_expr(r"const int span1 =\s*(.*?);"), **names)
    assert 0 <= span0 <= span1 < len(keep_row)
    return any(bool(x) for x in keep_row[span0:span1 + 1])


@pytest.mark.parametrize("span, nref", BWD_SPANS)
@pytest.mark.parametrize("d", [40, 80, 160])
def test_dq_walk_covers_the_kept_rows(span, nref, d):
    """DQ's walk over its K/V tiles of BC rows (the built masked line at
    head dim d), for every keep row the smoke and training draw and one
    that keeps nothing: every kept kv row is walked, no walked tile lies
    wholly in dropped spans, and a row that keeps nothing walks none."""
    bc = fa.bwd_tile("dq", d, True)[1]
    skv = span * nref
    keep = torch.tensor(KEEP_ROWS, dtype=torch.bool)
    mask = fa.keep_to_mask(keep, skv)[:, 0, 0, :]
    for i, row in enumerate(KEEP_ROWS):
        tiles = _dq_walk(row, skv, bc)
        covered = torch.zeros(skv, dtype=torch.bool)
        for t in tiles:
            assert bool(mask[i, t * bc:min(t * bc + bc, skv)].any())
            covered[t * bc:min(t * bc + bc, skv)] = True
        assert bool((covered | ~mask[i]).all())
        if not any(row):
            assert tiles == []


@pytest.mark.parametrize("span, nref", BWD_SPANS)
@pytest.mark.parametrize("d", [40, 80, 160])
def test_dkv_dropped_blocks_hold_no_kept_row(span, nref, d):
    """DKV's blocks of BR kv rows (the built masked line at head dim d): a
    block is live exactly where it holds a kept row; a dead one (which
    writes zeros and loads nothing) lies wholly in dropped spans, and
    every block of a row that keeps nothing is dead."""
    br = fa.bwd_tile("dkv", d, True)[0]
    skv = span * nref
    keep = torch.tensor(KEEP_ROWS, dtype=torch.bool)
    mask = fa.keep_to_mask(keep, skv)[:, 0, 0, :]
    for i, row in enumerate(KEEP_ROWS):
        for blk in range(-(-skv // br)):
            live = _dkv_block_live(row, skv, br, blk)
            rows = mask[i, blk * br:min(blk * br + br, skv)]
            assert live == bool(rows.any())
            if not any(row):
                assert not live
