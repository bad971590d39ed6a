"""The tiles of kernel G (csrc/geglu_matmul.cu), without a card: the Python
table of built instantiations against the source's SG_BUILT lines, the
shared memory and warp layout of every built and candidate tile, the
wrapper's choice at every feed-forward site of serving and training
(split-K at the few-row sites, the whole width at the first level), a
ValueError for what is not built, the tile study's rewrite of the source
and its ptxas parsing, and the study's CPU path at a tiny shape. The
kernel itself runs only on the card (chip_smoke.py)."""
import math
import re

import numpy as np
import pytest
import torch

from storygen_tpu_torch.ops import _build, geglu
from storygen_tpu_torch.studies import common, geglu_tiles

BLOCK_SMEM = 232448  # a block's dynamic shared memory


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
    lines = _built_lines((_build.CSRC / "geglu_matmul.cu").read_text())
    table = {line[:2] + (line[4],): line[2:] for line in lines}
    assert len(table) == len(lines)  # one line per (E, M class, K step)
    assert table == geglu.GEGLU_BUILT
    # in the source's order: of one (E, M class) the K step 64 comes first
    keys = list(table)
    assert keys == list(geglu.GEGLU_BUILT)
    for i, (e, mc, bk) in enumerate(keys):
        assert bk == 64 or (e, mc, 64) in keys[:i]


def test_m_class_matches_the_cuda_source():
    src = (_build.CSRC / "geglu_matmul.cu").read_text()
    assert "return m <= 512 ? 0 : (m <= 2048 ? 1 : 2);" in src
    assert [geglu.m_class(m) for m in (1, 512, 513, 2048, 2049)] == \
        [0, 0, 1, 1, 2]


def _check_tile(tile):
    """The static_asserts of geglu_matmul.cu's GegluCfg."""
    bm, be, bk, wm, we, stages, split = tile
    assert bm % (16 * wm) == 0 and be % (16 * we) == 0
    assert bk % 16 == 0 and stages >= 2 and split >= 1
    assert 32 <= 32 * wm * we <= 1024
    assert geglu_tiles.shared_bytes(tile) <= BLOCK_SMEM


@pytest.mark.parametrize("key", sorted(geglu.GEGLU_BUILT))
def test_every_built_tile_fits_a_block(key):
    _check_tile(geglu.GEGLU_BUILT[key])


@pytest.mark.parametrize("key", sorted(geglu_tiles.CANDIDATES))
def test_every_study_candidate_fits_a_block(key):
    for tile in geglu_tiles.CANDIDATES[key]:
        _check_tile(tile)


def _rational_erf_source():
    """The coefficients of the kernel's rational erf, read from the
    source: numerator a13 .. a1, denominator b8 .. b0."""
    src = (_build.CSRC / "geglu_matmul.cu").read_text()
    body = src[src.index("float erf_of(float x)"):]
    body = body[:body.index("return __fdividef")]
    num = r"(-?\d+\.\d+e-?\d+)f"
    a = re.findall(r"float p = fmaf\(x2, " + num + ", " + num, body)[0]
    a += tuple(re.findall(r"p = fmaf\(x2, p, " + num, body))
    b = re.findall(r"float q = fmaf\(x2, " + num + ", " + num, body)[0]
    b += tuple(re.findall(r"q = fmaf\(x2, q, " + num, body))
    return [np.float32(x) for x in a], [np.float32(x) for x in b]


def test_rational_erf_of_the_kernel_is_within_1e6():
    """The kernel's erf, evaluated in fp32 with the source's coefficients, is
    within 1e-6 of erf everywhere (the gated product is then rounded to
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
    or selectable per tile."""
    src = (_build.CSRC / "geglu_matmul.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert code.count("erf_of(") == 3  # its definition and the two uses
    assert "erff(" not in code and "__expf(" not in code
    assert "template <int ERF>" not in code
    assert {len(t) for t in geglu.GEGLU_BUILT.values()} == {7}


def test_shared_bytes_counts_the_ring():
    # BK 64: rows of 128 bytes padded to 144 (an odd number of 16-byte
    # units); value, gate (64 rows each) and W (320 rows), three stages
    assert geglu_tiles.shared_bytes((64, 320, 64, 2, 4, 3, 1)) == \
        3 * (2 * 64 * 144 + 320 * 144)
    # BK 32: 64-byte rows padded to 80
    assert geglu_tiles.shared_bytes((128, 160, 32, 4, 2, 2, 1)) == \
        2 * (2 * 128 * 80 + 160 * 80)


# (M, N, E) of every feed-forward of the 512 px UNet in serving (main
# pass B3, reference pass B6), stage-2 training (B4, reference pass B12)
# and a 256 px micro-step (B4, reference pass B12)
SITES = [(m * r, 4 * e, e) for r in (3, 6, 4, 12)
         for m, e in ((4096, 320), (1024, 640), (256, 1280), (64, 1280))]
SITES += [(m * r, 4 * e, e) for r in (4, 12)
          for m, e in ((1024, 320), (256, 640), (64, 1280), (16, 1280))]


@pytest.mark.parametrize("m, n, e", SITES)
def test_tile_choice_at_the_sites_is_built(m, n, e):
    tile = geglu.geglu_tile(m, n, e)
    assert tile == geglu.GEGLU_BUILT[(e, geglu.m_class(m), 64)]
    assert n % tile[2] == 0


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_tile_at_every_tensor_parallel_shard(tp):
    """Every UNet level's feed-forward inner shard (N = 4 E / tp, E
    unsharded) at 512 px in serving (main pass B3, reference pass B6) and
    training (B4) has a built tile whose K step divides it; the K step 32
    only at the first level's N = 160 of tp = 8, and below tp = 8 the
    tile of the unsharded width."""
    for rows in (3, 6, 4):
        for tokens, e in ((4096, 320), (1024, 640), (256, 1280),
                          (64, 1280)):
            m, n = rows * tokens, 4 * e // tp
            tile = geglu.geglu_tile(m, n, e)
            assert n % tile[2] == 0
            assert tile[2] == (32 if n == 160 else 64)
            if tp < 8:
                assert tile == geglu.geglu_tile(m, 4 * e, e)


@pytest.mark.parametrize("m", [64, 192, 256, 384, 768, 1024, 1536])
def test_split_k_at_the_few_row_sites(m):
    """The mid block's and L3's rows fill the card only with split-K."""
    assert geglu.geglu_tile(m, 5120, 1280)[6] > 1


@pytest.mark.parametrize("m", [3 * 4096, 4 * 4096, 6 * 4096, 12 * 4096])
def test_first_level_reads_proj_once(m):
    """No split-K at L1, and one block spans the whole E = 320, as the TPU
    kernel's (BM, E) output block: the projection is read once."""
    bm, be, *_, split = geglu.geglu_tile(m, 1280, 320)
    assert split == 1 and be == 320


@pytest.mark.parametrize("m, n, e", [(12288, 1280, 48), (192, 5120, 1000),
                                     (4096, 2560, 320 + 8)])
def test_geglu_tile_raises_for_an_unbuilt_key(m, n, e):
    with pytest.raises(ValueError, match="no GEGLU kernel built"):
        geglu.geglu_tile(m, n, e)


def test_geglu_tile_raises_for_a_ragged_k_step():
    bk = geglu.geglu_tile(192, 5120, 1280)[2]
    with pytest.raises(ValueError, match="multiple of the K step"):
        geglu.geglu_tile(192, 5120 + bk // 2, 1280)


def test_cpu_wrapper_needs_no_built_tile():
    """On the CPU the wrapper runs the plain version at any width, and
    counts no launch."""
    rng = np.random.default_rng(0)
    proj = torch.tensor(rng.standard_normal((10, 2 * 48)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((24, 48)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal(24), dtype=torch.float32)
    before = geglu.geglu_matmul.launches
    out = geglu.geglu_matmul(proj, w, b)
    assert geglu.geglu_matmul.launches == before
    torch.testing.assert_close(out, geglu.geglu_matmul_plain(proj, w, b))


@pytest.mark.parametrize("key", sorted(geglu_tiles.CANDIDATES))
def test_tile_study_rewrites_only_the_built_lines(key):
    src = (_build.CSRC / geglu_tiles.SOURCE).read_text()
    tile = geglu_tiles.CANDIDATES[key][-1]
    new = geglu_tiles.candidate_source(key, tile)
    assert _built_lines(new) == [key[:2] + tuple(tile)]
    strip = re.compile(r"^\s*SG_BUILT\(\d[^)]*\)\s*\n", re.M)
    assert strip.sub("", new) == strip.sub("", src)


def test_tile_study_covers_every_key_of_its_shapes():
    for name in geglu_tiles.SHAPES:
        key = geglu_tiles.shape_key(name)
        assert key == geglu.tile_key(*geglu_tiles.SHAPES[name])
        assert key in geglu.GEGLU_BUILT and key in geglu_tiles.CANDIDATES
        # the built tile is among the candidates it was chosen from
        assert geglu.GEGLU_BUILT[key] in geglu_tiles.CANDIDATES[key]


def test_ptxas_summary_reads_registers_and_spills():
    out = (
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_116geglu_mma_kernelILi64EEEvNS_9GegluArgsE' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_116geglu\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 4 bytes smem\n"
        "ptxas info    : Compiling entry function 'other' for 'sm_90a'\n"
        "    24 bytes stack frame, 20 bytes spill stores, 28 bytes spill "
        "loads\n"
        "ptxas info    : Used 255 registers\n")
    rows = common.ptxas_summary(out)
    assert rows == [
        ("_ZN12_GLOBAL__N_116geglu_mma_kernelILi64EEEvNS_9GegluArgsE", 168,
         0, 0, 0),
        ("other", 255, 24, 20, 28)]


def test_tile_study_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        geglu_tiles.main(shapes=["mid_main"], iters=1)


def test_tile_study_runs_the_plain_path_on_the_cpu(capsys):
    shapes = [("tiny", 40, 64, 48), ("tiny_split", 24, 128, 32)]
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


def test_split_k_counters_are_kept_per_stream_and_grow():
    """One zeroed counter buffer per (device, stream), reused while it is
    large enough (every launch leaves it zeroed)."""
    dev = torch.device("cpu")
    a = geglu._tile_counters(dev, 11, 10)
    assert a.dtype == torch.int32 and a.numel() >= 10 and not a.any()
    assert geglu._tile_counters(dev, 11, 20) is a
    assert geglu._tile_counters(dev, 12, 10) is not a
    big = geglu._tile_counters(dev, 11, a.numel() + 1)
    assert big.numel() > a.numel() and not big.any()
    assert geglu._tile_counters(dev, 11, 5) is big
