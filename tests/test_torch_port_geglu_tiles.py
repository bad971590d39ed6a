"""The tiles of kernel G (csrc/geglu_matmul.cu over csrc/geglu_wgmma.cuh),
without a card: the Python table of built instantiations against the
source's SG_BUILT lines, the shared memory of every built and candidate
tile, the TMA boxes of a stage (value at k0, gate at N + k0 of one map),
the header's wgmma on TMA-fed tiles, the split plan as a function of the
rows per image, N and E (the same at every batch), the wrapper's choice
at every feed-forward site of serving and training, a ValueError for what
is not built, the tile study's rewrite of the source and its ptxas
parsing, the split's cluster reduction in split order, and the study's
CPU path at a tiny shape. The kernel itself runs only on the card
(chip_smoke.py)."""
import math
import re

import numpy as np
import pytest
import torch

from storygen_tpu_torch.ops import _build, geglu
from storygen_tpu_torch.studies import common, geglu_tiles

BLOCK_SMEM = 232448  # a block's dynamic shared memory
SOURCE = (_build.CSRC / "geglu_matmul.cu").read_text()
HEADER = (_build.CSRC / "geglu_wgmma.cuh").read_text()


def _code(src: str) -> str:
    """The source without its comments."""
    return "\n".join(line.split("//")[0] for line in src.splitlines())


def shared_bytes(tile):
    """Dynamic shared memory of an instantiation (geglu_wgmma.cuh's
    GegluCfg::BYTES): 1 KB of alignment, a ring of value, gate and W boxes
    (or, if larger, the split's fp32 partial tile of rows of BE + 8 floats
    that reuses it), and a full and an empty barrier a stage."""
    wgc, be, wn, bk, stages, _ = tile
    stage = 2 * (64 * wgc) * (2 * bk) + be * (2 * bk)
    part = 64 * wgc * (be + 8) * 4
    return 1024 + max(stages * stage, part) + 16 * stages


def stage_boxes(tile, n, step, m0, e0):
    """The TMA boxes of inner step `step` for the block at rows m0 and
    columns e0, as the header's producer issues them: (map, first
    coordinate, second coordinate, box) with the maps proj (2N, M) and W
    (N, E): the value box at (k0, m0), the gate box at (N + k0, m0), then
    BE / WN W boxes at (k0, e0 + p WN)."""
    wgc, be, wn, bk = tile[:4]
    k0, bm = step * bk, 64 * wgc
    boxes = [("proj", k0, m0, (bk, bm)), ("proj", n + k0, m0, (bk, bm))]
    boxes += [("w", k0, e0 + p * wn, (bk, wn)) for p in range(be // wn)]
    return boxes


def _built_lines(src: str):
    """The integer arguments of every SG_BUILT invocation (not the macro's
    own definition)."""
    out = []
    for args in re.findall(r"^\s*SG_BUILT\(([^)]*)\)\s*$", src, re.M):
        if any(a.strip().endswith("_") for a in args.split(",")):
            continue
        out.append(tuple(int(a) for a in args.split(",")))
    return out


def test_geglu_built_matches_the_cuda_source():
    lines = _built_lines(SOURCE)
    table = {line[:2] + (line[5],): line[2:] for line in lines}
    assert len(table) == len(lines)  # one line per (E, site class, K step)
    assert table == geglu.GEGLU_BUILT
    # in the source's order: of one (E, site class) the K step 64 first
    keys = list(table)
    assert keys == list(geglu.GEGLU_BUILT)
    for i, (e, sc, bk) in enumerate(keys):
        assert bk == 64 or (e, sc, 64) in keys[:i]


def test_m_class_matches_the_cuda_source():
    """The site class reads the rows per image, never M: the source's
    site_class and the Python one agree at the class boundaries."""
    assert "return tokens <= 128 ? 0 : (tokens <= 512 ? 1 : 2);" in SOURCE
    assert "site_class(tokens)" in SOURCE and "site_class(M)" not in SOURCE
    assert [geglu.site_class(t) for t in (1, 64, 128, 129, 256, 512, 513,
                                          1024, 4096)] == \
        [0, 0, 0, 1, 1, 1, 2, 2, 2]


def test_split_rule_matches_the_cuda_source():
    assert "const int most = nk / 4 > 1 ? nk / 4 : 1;" in SOURCE
    assert "return split < most ? split : most;" in SOURCE
    assert "split_count(SPLIT_, N / BK_)" in SOURCE
    for split in (1, 2, 4, 8, 16):
        for bk in (32, 64):
            for n in (160, 320, 640, 1280, 2560, 5120):
                nk = n // bk
                most = max(1, nk // 4)
                tile = (1, 320, 160, bk, 4, split)
                assert geglu.split_count(tile, n) == min(split, most)


def _check_tile(tile):
    """The static_asserts of geglu_wgmma.cuh's GegluCfg, the cluster's
    portable size, and the registers a thread at the launch's cap."""
    wgc, be, wn, bk, stages, split = tile
    bm = 64 * wgc
    assert 1 <= wgc <= 3 and be % wn == 0 and wn % 16 == 0 and wn <= 256
    assert bk in (32, 64) and stages >= 2 and 1 <= split <= 8
    # every box on the 1024-byte swizzle period, TMA boxes <= 256 rows
    assert (bm * 2 * bk) % 1024 == 0 and (wn * 2 * bk) % 1024 == 0
    assert bm <= 256
    # the accumulators: BE / 2 fp32 a consumer thread, within its budget
    # (255 with one consumer warpgroup and a producer warp; 232 and 152
    # with two and three after the producer warpgroup's setmaxnreg), with
    # room for the fragments, the gelu and the addresses
    regs = 512 // (wgc + 1) // 8 * 8
    rise = min(240, (regs + (regs - 40) // wgc) // 8 * 8)
    budget = 255 if wgc == 1 else rise
    assert budget == {1: 255, 2: 232, 3: 152}[wgc]
    assert be // 2 <= budget - 64
    assert shared_bytes(tile) <= BLOCK_SMEM


@pytest.mark.parametrize("key", sorted(geglu.GEGLU_BUILT))
def test_every_built_tile_fits_a_block(key):
    _check_tile(geglu.GEGLU_BUILT[key])


@pytest.mark.parametrize("key", sorted(geglu_tiles.CANDIDATES))
def test_every_study_candidate_fits_a_block(key):
    for tile in geglu_tiles.CANDIDATES[key]:
        _check_tile(tile)


def _rational_erf_source():
    """The coefficients of the kernel's rational erf, read from the
    header: numerator a13 .. a1, denominator b8 .. b0."""
    body = HEADER[HEADER.index("float erf_of(float x)"):]
    body = body[:body.index("return __fdividef")]
    num = r"(-?\d+\.\d+e-?\d+)f"
    a = re.findall(r"float p = fmaf\(x2, " + num + ", " + num, body)[0]
    a += tuple(re.findall(r"p = fmaf\(x2, p, " + num, body))
    b = re.findall(r"float q = fmaf\(x2, " + num + ", " + num, body)[0]
    b += tuple(re.findall(r"q = fmaf\(x2, q, " + num, body))
    return [np.float32(x) for x in a], [np.float32(x) for x in b]


def test_rational_erf_of_the_kernel_is_within_1e6():
    """The kernel's erf, evaluated in fp32 with the header's coefficients,
    is within 1e-6 of erf everywhere (the gated product is then rounded to
    bf16, 2^-9 relative)."""
    a, b = _rational_erf_source()
    assert len(a) == 7 and len(b) == 5
    x = np.linspace(-6, 6, 60001, dtype=np.float32)
    xc = np.clip(x, np.float32(-4), np.float32(4))
    x2 = xc * xc
    p = a[0]
    for c in a[1:]:
        p = x2 * p + c
    q = b[0]
    for c in b[1:]:
        q = x2 * q + c
    approx = xc * p / q
    exact = np.array([math.erf(float(v)) for v in x])
    assert np.abs(approx - exact).max() < 1e-6


def test_built_tiles_use_the_rational_gelu():
    """The rational erf is the kernel's only gelu: no other form is built
    or selectable per tile, and the gated product is formed pair by pair
    from the value and gate fragments."""
    code = _code(HEADER)
    assert code.count("erf_of(") == 3  # its definition and the two uses
    assert "erff(" not in code and "__expf(" not in code
    assert "af[j] = gated2(v[j], gt[j]);" in code
    assert "erf_of(" not in _code(SOURCE)
    assert {len(t) for t in geglu.GEGLU_BUILT.values()} == {6}


def test_shared_bytes_counts_the_ring():
    # two consumer warpgroups, BK 64: value and gate boxes of 128 rows of
    # 128 bytes, two W boxes of 160 rows, three stages; 1 KB of alignment
    # and two barriers a stage
    assert shared_bytes((2, 320, 160, 64, 3, 1)) == \
        1024 + 3 * (2 * 128 * 128 + 2 * 160 * 128) + 3 * 16
    # one consumer warpgroup, BK 32: 64-byte rows
    assert shared_bytes((1, 256, 256, 32, 6, 1)) == \
        1024 + 6 * (2 * 64 * 64 + 256 * 64) + 6 * 16
    # a split's fp32 partial tile (rows of BE + 8 floats) where it is
    # larger than the ring it reuses
    assert shared_bytes((2, 320, 160, 32, 2, 4)) == \
        1024 + 128 * 328 * 4 + 2 * 16
    assert "BYTES =\n      1024 + (RING > PART ? RING : PART) + 16 * STAGES;" \
        in HEADER
    assert "STAGE = 2 * ATILE + NB * WPANEL;" in HEADER
    assert "PART = BM * PITCH * 4;" in HEADER and \
        "PITCH = BE + 8;" in HEADER


def test_header_runs_wgmma_on_tma_fed_tiles():
    """Every built line runs the wgmma template: TMA boxes into a ring of
    full and empty mbarriers, the gated product as wgmma's register-A
    operand and W by a K-major descriptor; no mma.sync, cp.async or
    shared-memory write-back of the gated product is left in G."""
    code = _code(HEADER)
    assert "WgMma<WN>::template run<0>(" in code
    # a producer warp beside one consumer warpgroup, else a warpgroup
    # that gives its registers to the consumers
    assert "NT = NTC + (WGC == 1 ? 32 : 128);" in code
    assert "__launch_bounds__(128 * WGC + (WGC == 1 ? 32 : 128), 1)" in code
    assert "if constexpr (WGC > 1) setmaxnreg_inc<C::CONSUMER_REGS>();" \
        in code
    assert "smem_desc(ws + p * C::WPANEL + 32 * kk, 0, 8 * RB," in code
    assert code.count("tma_load_2d(") == 3
    assert "mbar_wait(full + 8 * s" in code and \
        "mbar_arrive(empty + 8 * ((i - 1) % STAGES))" in code
    for banned in ("mma_bf16(", "cp_async16(", "cp_async_wait", "ldsm_x4(",
                   "__syncthreads();\n    if (i", "fence.proxy.async",
                   "st.shared", "atomicAdd"):
        assert banned not in code, banned
        assert banned not in _code(SOURCE), banned
    assert "wg_launch<WGC_, BE_, WN_, BK_, STAGES_, true>" in SOURCE
    assert '#include "geglu_wgmma.cuh"' in SOURCE
    # hopper.cuh's register-A product takes the transpose bit as TB, at
    # each of its N (48, 64, 80, 96, 128, 160, 176, 256)
    hopper = (_build.CSRC / "hopper.cuh").read_text()
    assert hopper.count("  template <int TB = 1>\n  static __device__") == \
        hopper.count('"n"(TB)') == hopper.count("struct WgMma<") == 8


def test_tma_boxes_of_a_stage():
    """The producer's three kinds of box, mirrored by stage_boxes:
    value at (k0, m0) and gate at (N + k0, m0) of the one map over proj
    seen as (2N, M), and BE / WN W boxes at (k0, e0 + p WN) of the map over
    W seen as (N, E); the maps' boxes are (BK, BM) and (BK, WN)."""
    assert "tma_load_2d(st, &tmp, bar, k, m0);" in HEADER
    assert "tma_load_2d(st + C::ATILE, &tmp, bar, a.N + k, m0);" in HEADER
    assert re.search(r"tma_load_2d\(st \+ 2 \* C::ATILE \+ p \* C::WPANEL, "
                     r"&tmw, bar, k,\s+e0 \+ p \* WN\);", HEADER)
    assert "const cuuint64_t pdim[2] = {2 * (cuuint64_t)a.N, " \
        "(cuuint64_t)a.M};" in HEADER
    assert "const cuuint64_t wdim[2] = {(cuuint64_t)a.N, (cuuint64_t)a.E};" \
        in HEADER
    tile = (2, 320, 160, 64, 3, 4)
    boxes = stage_boxes(tile, 5120, 3, 128, 640)
    assert boxes == [("proj", 192, 128, (64, 128)),
                     ("proj", 5120 + 192, 128, (64, 128)),
                     ("w", 192, 640, (64, 160)), ("w", 192, 800, (64, 160))]
    # the bytes a stage's boxes land are its share of the ring and the
    # full barrier's transaction count
    landed = sum(2 * bx[3][0] * bx[3][1] for bx in boxes)
    assert 3 * landed == shared_bytes(tile) - 1024 - 3 * 16
    assert "mbar_expect_tx(bar, C::STAGE);" in HEADER


@pytest.mark.parametrize("key", sorted(geglu.GEGLU_BUILT))
def test_tma_boxes_cover_a_built_tile(key):
    """At every built line the boxes of a step cover the block's BM rows of
    value and gate, the gate BN = N columns on, and its BE output rows of
    W, each inner box BK wide (one swizzle span) and at most 256 rows."""
    e, _, bk = key
    tile = geglu.GEGLU_BUILT[key]
    n = 4 * e if bk == 64 else 160
    boxes = stage_boxes(tile, n, 1, 0, 0)
    value, gate, *ws = boxes
    assert value[1] == bk and gate[1] == n + bk and value[2] == gate[2] == 0
    assert value[3] == gate[3] == (bk, 64 * tile[0])
    assert sum(b[3][1] for b in ws) == tile[1]
    assert all(b[3] == (bk, tile[2]) and b[3][1] <= 256 for b in ws)


# (M, N, E, rows per image) of every feed-forward of the 512 px UNet in
# serving (main pass B3, reference pass B6), stage-2 training (B4,
# reference pass B12) and a 256 px micro-step (B4, reference pass B12)
SITES = [(r * t, 4 * e, e, t) for r in (3, 6, 4, 12)
         for t, e in ((4096, 320), (1024, 640), (256, 1280), (64, 1280))]
SITES += [(r * t, 4 * e, e, t) for r in (4, 12)
          for t, e in ((1024, 320), (256, 640), (64, 1280), (16, 1280))]


@pytest.mark.parametrize("m, n, e, tokens", SITES)
def test_tile_choice_at_the_sites_is_built(m, n, e, tokens):
    tile = geglu.geglu_tile(tokens, n, e)
    assert tile == geglu.GEGLU_BUILT[(e, geglu.site_class(tokens), 64)]
    assert n % tile[3] == 0


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_tile_at_every_tensor_parallel_shard(tp):
    """Every UNet level's feed-forward inner shard (N = 4 E / tp, E
    unsharded) at 512 px has a built tile whose K step divides it; the K
    step 32 only at the first level's N = 160 of tp = 8, and below tp = 8
    the tile of the unsharded width."""
    for tokens, e in ((4096, 320), (1024, 640), (256, 1280), (64, 1280)):
        n = 4 * e // tp
        tile = geglu.geglu_tile(tokens, n, e)
        assert n % tile[3] == 0
        assert tile[3] == (32 if n == 160 else 64)
        if tp < 8:
            assert tile == geglu.geglu_tile(tokens, 4 * e, e)


# (rows per image, N, E) of each feed-forward site of the 256, 512 and 768
# px UNets, and of the tp = 2 / 8 shards at 512 px
PLAN_SITES = sorted({(t, 4 * e, e) for t, e in (
    (4096, 320), (1024, 640), (256, 1280), (64, 1280), (1024, 320),
    (256, 640), (16, 1280), (9216, 320), (2304, 640), (576, 1280),
    (144, 1280))} | {(4096, 640, 320), (4096, 160, 320), (1024, 320, 640),
                     (256, 640, 1280), (64, 2560, 1280)})


@pytest.mark.parametrize("tokens, n, e", PLAN_SITES)
def test_split_plan_ignores_the_batch(tokens, n, e):
    """The line, its split and each split's run of inner steps are a
    function of (rows per image, N, E): the same for every batch from 1 to
    12, so a row's order of summation does not depend on the images that
    share its call. The split never leaves a run empty."""
    tile = geglu.geglu_tile(tokens, n, e)
    split = geglu.split_count(tile, n)
    nk = n // tile[3]
    runs = [((z + 1) * nk // split) - z * nk // split for z in range(split)]
    assert sum(runs) == nk and min(runs) >= 1
    for b in range(1, 13):
        # the launch reads M only for its grid
        assert geglu.geglu_tile(tokens, n, e) == tile
        assert geglu.split_count(geglu.geglu_tile(tokens, n, e), n) == split


@pytest.mark.parametrize("tokens", [16, 64, 128, 256, 512])
def test_split_k_at_the_few_row_sites(tokens):
    """The mid block's and L3's rows fill the card only with a split of
    the N reduction."""
    tile = geglu.geglu_tile(tokens, 5120, 1280)
    assert geglu.split_count(tile, 5120) > 1


@pytest.mark.parametrize("tokens", [4096, 1024, 9216, 2304])
def test_first_level_reads_proj_once(tokens):
    """No split at the first two levels' many rows, and one block spans
    the whole E = 320 as two N = 160 products, as the TPU kernel's (BM, E)
    output block: the projection is read once and each gelu computed
    once."""
    tile = geglu.geglu_tile(tokens, 1280, 320)
    assert geglu.split_count(tile, 1280) == 1 and tile[1] == 320


@pytest.mark.parametrize("tokens, n, e", [(4096, 1280, 48),
                                          (64, 5120, 1000),
                                          (1024, 2560, 320 + 8)])
def test_geglu_tile_raises_for_an_unbuilt_key(tokens, n, e):
    with pytest.raises(ValueError, match="no GEGLU kernel built"):
        geglu.geglu_tile(tokens, n, e)


def test_geglu_tile_raises_for_a_ragged_k_step():
    bk = geglu.geglu_tile(64, 5120, 1280)[3]
    with pytest.raises(ValueError, match="multiple of the K step"):
        geglu.geglu_tile(64, 5120 + bk // 2, 1280)


def test_cpu_wrapper_needs_no_built_tile():
    """On the CPU the wrapper runs the plain version at any width and any
    rows per image, and counts no launch; a rows per image below 1 is
    refused."""
    rng = np.random.default_rng(0)
    proj = torch.tensor(rng.standard_normal((10, 2 * 48)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((24, 48)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal(24), dtype=torch.float32)
    before = geglu.geglu_matmul.launches
    out = geglu.geglu_matmul(proj, w, b)
    assert geglu.geglu_matmul.launches == before
    torch.testing.assert_close(out, geglu.geglu_matmul_plain(proj, w, b))
    torch.testing.assert_close(geglu.geglu_matmul(proj, w, b, 5), out)
    with pytest.raises(ValueError, match="rows per image"):
        geglu.geglu_matmul(proj, w, b, 0)


def test_feed_forward_passes_its_rows_per_image(monkeypatch):
    """FeedForward hands kernel G the tokens of one image (x.shape[-2]),
    so that the tile and split follow the site, not the batch."""
    from storygen_tpu_torch.models import attention
    seen = []

    def spy(proj, weight, bias, tokens=None):
        seen.append((proj.shape[0], tokens))
        return geglu.geglu_matmul_plain(proj, weight, bias)

    monkeypatch.setattr(attention, "geglu_matmul_plain", spy)
    monkeypatch.setattr(attention, "route", lambda kernel, plain: plain)
    ff = attention.FeedForward(8)
    x = torch.randn(3, 5, 8)
    out = ff(x)
    assert out.shape == (3, 5, 8) and seen == [(15, 5)]


@pytest.mark.parametrize("key", sorted(geglu_tiles.CANDIDATES))
def test_tile_study_rewrites_only_the_built_lines(key):
    tile = geglu_tiles.CANDIDATES[key][-1]
    new = geglu_tiles.candidate_source(key, tile)
    assert _built_lines(new) == [key[:2] + tuple(tile)]
    strip = re.compile(r"^\s*SG_BUILT\(\d[^)]*\)\s*\n", re.M)
    assert strip.sub("", new) == strip.sub("", SOURCE)


def test_tile_study_covers_every_key_of_its_shapes():
    keys = set()
    for name in geglu_tiles.SHAPES:
        key = geglu_tiles.shape_key(name)
        _, m, n, e, tokens = geglu_tiles.spec(name)
        assert key == geglu.tile_key(tokens, n, e)
        assert key in geglu.GEGLU_BUILT and key in geglu_tiles.CANDIDATES
        # the built tile is among the candidates it was chosen from
        assert geglu.GEGLU_BUILT[key] in geglu_tiles.CANDIDATES[key]
        keys.add(key)
    assert keys == set(geglu.GEGLU_BUILT)


def test_ptxas_summary_reads_registers_and_spills():
    out = (
        "ptxas info    : Compiling entry function "
        "'_ZN8sg_geglu15geglu_wg_kernelILi2ELi320ELi160ELi64ELi3ELb0EEEv"
        "14CUtensorMap_stS1_NS_9GegluArgsE' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN8sg_geglu15geglu\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 4 bytes smem\n"
        "ptxas info    : Compiling entry function 'other' for 'sm_90a'\n"
        "    24 bytes stack frame, 20 bytes spill stores, 28 bytes spill "
        "loads\n"
        "ptxas info    : Used 255 registers\n")
    rows = common.ptxas_summary(out)
    assert rows == [
        ("_ZN8sg_geglu15geglu_wg_kernelILi2ELi320ELi160ELi64ELi3ELb0EEEv"
         "14CUtensorMap_stS1_NS_9GegluArgsE", 168, 0, 0, 0),
        ("other", 255, 24, 20, 28)]
    # the smoke's geglu_ptxas reads the template arguments from the name
    m = re.search(r"geglu_wg_kernel[^I]*I((?:L[ib]-?\d+E)+)E", rows[0][0])
    assert tuple(int(v) for v in re.findall(r"L[ib](-?\d+)E", m.group(1))) \
        == (2, 320, 160, 64, 3, 0)


def test_tile_study_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        geglu_tiles.main(shapes=["mid_main"], iters=1)


def test_tile_study_runs_the_plain_path_on_the_cpu(capsys):
    shapes = [("tiny", 40, 64, 48, 20), ("tiny_split", 24, 128, 32, 8)]
    geglu_tiles.main(device="cpu", shapes=shapes, iters=1)
    out = capsys.readouterr().out
    for name, *_ in shapes:
        for row in ("plain (cpu)", "built"):
            line = next(x for x in out.splitlines()
                        if x.startswith(name + " ") and row in x)
            assert "[cpu host clock]" in line
            # the wrapper's CPU path is the plain version: bf16 rounding
            # of the output against the fp32 oracle only
            err = float(re.search(r"maxerr (\S+)", line).group(1))
            assert err < 0.05
    assert "FAILED" not in out and "unfused" not in out


def test_split_adds_the_cluster_partials_in_split_order():
    """A split's blocks form a cluster (1, 1, split); after a cluster
    barrier each block adds its z-th of the tile over ranks 0 .. split - 1
    in that order, from the peers' shared memory, so the sum does not
    depend on which block finishes first, and no partial reaches device
    memory (no scratch, no counters, one launch)."""
    code = _code(HEADER)
    assert "cluster[0].val.clusterDim.z = split;" in code
    assert "cudaLaunchKernelEx(&cfg, kern, tmp, tmw, a)" in code
    assert code.count("cluster_sync();") == 4  # producer 2, consumers 2
    # every producer thread meets both barriers before it leaves
    assert code.index("cluster_sync();") < code.index("return;")
    assert "for (int s = 0; s < split; ++s) {" in code
    assert "ld_cluster_f4(cluster_map(" in code
    assert "split > 8" in code  # a cluster's portable size
    assert not re.search(r"\b(part|count)\b", _code(SOURCE))
    sig = _build.SIGNATURES["sg_geglu_matmul"]
    assert len(sig) == 10  # proj, w, bias, fp32, out, M, N, E, tokens, stream


@pytest.mark.parametrize("variant", sorted(geglu_tiles.ABLATIONS))
def test_ablation_edits_match_the_header_once(variant):
    """The study's ablations stay in step with the header: each edit
    matches exactly once, and what it takes out is gone."""
    text = geglu_tiles.ablated_header(geglu_tiles.ABLATIONS[variant])
    assert ("gated2(v[j], gt[j])" in text) == (variant == "no products")
    assert ("WgMma<WN>::template run<0>" in text) == (variant == "no gelu")
    assert geglu_tiles.ablated_header([]) == HEADER
    with pytest.raises(ValueError, match="matched 0 times"):
        geglu_tiles.ablated_header([("no such text", "")])


def test_ablation_needs_the_card():
    with pytest.raises(RuntimeError, match="needs the card"):
        geglu_tiles.ablate(device="cpu", shapes=["mid_main"], iters=1)
