"""Port parity for the flash-forward study kernels (ops/study_attention.py):
each wrapper on CPU tensors, i.e. its plain PyTorch version, against the
Pallas kernel of scripts/studies/ it replaces, run in TPU interpret mode
(`pltpu.force_tpu_interpret_mode()`), on the same seeded numpy inputs, for
every knob the study sweeps. fp32 within 1e-4 and bf16 within 1e-2 of the
largest reference magnitude. Also the wrappers' input checks and the
ported study entry points (storygen_tpu_torch/studies/) at a tiny size on
the CPU. The CUDA kernels themselves run only on the card
(chip_smoke.py's studies phase)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from storygen_tpu_torch.ops import study_attention as sa
from tests.torch_port_util import rand

B, H, SQ, SKV = 1, 2, 256, 512
DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The plain versions' matmuls on 2 threads, as the other heavy CPU
    test files run theirs beside tier-1's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def studies():
    """The JAX study modules. Importing one points JAX's compilation cache
    at the repository's .jax_cache; tests/conftest.py's two settings are
    put back afterwards."""
    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    mods = {n: importlib.import_module(f"scripts.studies.{n}") for n in (
        "bench_attn_variants", "bench_attn_v2", "bench_attn_scan",
        "bench_attn_ablate", "bench_attn_bnd2", "bench_attn_multihead")}
    for k, v in keep.items():
        jax.config.update(k, v)
    return mods


def _inputs(seed, d, dtype, b=B, h=H, sq=SQ, skv=SKV):
    jd, td, tol = DTYPES[dtype]
    arrs = [rand(seed + i, shape) for i, shape in enumerate(
        ((b, h, sq, d), (b, h, skv, d), (b, h, skv, d)))]
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs], tol)


def _run_jax(fn, *args, **kw):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*args, **kw).astype(jnp.float32))


def _close(ref, got, rel, msg=""):
    got = got.float().numpy()
    assert got.shape == ref.shape, (got.shape, ref.shape, msg)
    assert np.isfinite(got).all(), msg
    err = np.abs(got - ref).max()
    bound = rel * np.abs(ref).max()
    assert err <= bound, (msg, err, bound)


def _untouched(fn, *args, **kw):
    """Call a wrapper on CPU tensors; its launch count must not move."""
    before = [w.launches for w in sa.WRAPPERS]
    out = fn(*args, **kw)
    assert [w.launches for w in sa.WRAPPERS] == before
    return out


@pytest.mark.parametrize("fold,exp2,split2,d,dtype", [
    (False, False, False, 40, "fp32"), (True, False, False, 40, "fp32"),
    (True, True, False, 40, "fp32"), (True, True, True, 40, "fp32"),
    (True, False, False, 80, "fp32"),
    (False, False, False, 40, "bf16"), (True, True, True, 40, "bf16")])
def test_variant_attention(studies, fold, exp2, split2, d, dtype):
    (jq, jk, jv), (q, k, v), tol = _inputs(1, d, dtype)
    sm = d ** -0.5
    ref = _run_jax(studies["bench_attn_variants"].variant_attention, jq, jk,
                   jv, sm_scale=sm, bq=128, bk=128, fold_scale=fold,
                   use_exp2=exp2, split2=split2, use_ds=False)
    got = _untouched(sa.variant_attention, q, k, v, sm_scale=sm, bq=64,
                     bk=128, fold_scale=fold, use_exp2=exp2, split2=split2)
    _close(ref, got, tol)


@pytest.mark.parametrize("exp2,d,dtype", [
    (False, 40, "fp32"), (True, 40, "fp32"), (False, 80, "fp32"),
    (True, 80, "fp32"), (False, 160, "fp32"), (True, 160, "fp32"),
    (True, 40, "bf16")])
def test_t_attention(studies, exp2, d, dtype):
    sq = 64 if d == 160 else SQ
    (jq, jk, jv), (q, k, v), tol = _inputs(2, d, dtype, sq=sq)
    sm = d ** -0.5
    ref = _run_jax(studies["bench_attn_v2"].t_attention, jq, jk, jv,
                   sm_scale=sm, bq=min(128, sq), bk=128, use_exp2=exp2)
    got = _untouched(sa.t_attention, q, k, v, sm_scale=sm, bq=64, bk=64,
                     use_exp2=exp2)
    _close(ref, got, tol)


@pytest.mark.parametrize("d,dtype", [(40, "fp32"), (80, "fp32"),
                                     (160, "fp32"), (40, "bf16"),
                                     (80, "bf16")])
def test_tb_attention(studies, d, dtype):
    sq = 64 if d == 160 else SQ
    (jq, jk, jv), (q, k, v), tol = _inputs(3, d, dtype, sq=sq)
    sm = d ** -0.5
    ref = _run_jax(studies["bench_attn_v2"].tb_attention, jq, jk, jv,
                   sm_scale=sm, bq=min(128, sq), bk=128)
    got = _untouched(sa.tb_attention, q, k, v, sm_scale=sm, bq=64, bk=128)
    _close(ref, got, tol)


@pytest.mark.parametrize("d,dtype", [(40, "fp32"), (80, "fp32"),
                                     (40, "bf16")])
def test_bounded_attention(studies, d, dtype):
    (jq, jk, jv), (q, k, v), tol = _inputs(4, d, dtype)
    sm = d ** -0.5
    ref = _run_jax(studies["bench_attn_scan"].bounded_attention, jq, jk, jv,
                   sm_scale=sm, bq=128, bk=128)
    got = _untouched(sa.bounded_attention, q, k, v, sm_scale=sm, bq=128,
                     bk=64)
    _close(ref, got, tol)


@pytest.mark.parametrize("sub,d,dtype", [(2, 40, "fp32"), (4, 40, "fp32"),
                                         (2, 80, "fp32"), (4, 80, "bf16")])
def test_bounded_multi_attention(studies, sub, d, dtype):
    (jq, jk, jv), (q, k, v), tol = _inputs(5, d, dtype)
    sm = d ** -0.5
    ref = _run_jax(studies["bench_attn_scan"].bounded_multi_attention, jq,
                   jk, jv, sm_scale=sm, bq=128, bk=128, sub=sub)
    got = _untouched(sa.bounded_multi_attention, q, k, v, sm_scale=sm,
                     bq=64, bk=64, sub=sub)
    _close(ref, got, tol)


@pytest.mark.parametrize("do_exp,do_pv,halves,dtype", [
    (False, False, 1, "fp32"), (True, False, 1, "fp32"),
    (False, True, 1, "fp32"), (True, True, 1, "fp32"),
    (True, True, 2, "fp32"), (True, False, 1, "bf16"),
    (True, True, 2, "bf16")])
def test_ablate_attention(studies, do_exp, do_pv, halves, dtype):
    (jq, jk, jv), (q, k, v), tol = _inputs(6, 40, dtype)
    sm = 40 ** -0.5
    ref = _run_jax(studies["bench_attn_ablate"].ablate_attention, jq, jk, jv,
                   sm_scale=sm, bq=128, bk=128, do_exp=do_exp, do_pv=do_pv,
                   halves=halves)
    got = _untouched(sa.ablate_attention, q, k, v, sm_scale=sm, bq=128,
                     bk=128, do_exp=do_exp, do_pv=do_pv, halves=halves)
    _close(ref, got, tol)


@pytest.mark.parametrize("d,dtype", [(40, "fp32"), (80, "fp32"),
                                     (40, "bf16")])
def test_bnd2_attention(studies, d, dtype):
    (jq, jk, jv), (q, k, v), tol = _inputs(7, d, dtype)
    sm = d ** -0.5
    ref = _run_jax(studies["bench_attn_bnd2"].bnd2_attention, jq, jk, jv,
                   sm_scale=sm, bq=128, bk=128)
    got = _untouched(sa.bnd2_attention, q, k, v, sm_scale=sm, bq=128, bk=64)
    _close(ref, got, tol)


@pytest.mark.parametrize("g,d,dtype", [
    (2, 40, "fp32"), (4, 40, "fp32"), (8, 40, "fp32"), (2, 80, "fp32"),
    (8, 80, "bf16"), (2, 160, "fp32"), (4, 160, "fp32"), (8, 160, "fp32")])
def test_mh_attention(studies, g, d, dtype):
    sq = 64 if d == 160 else SQ
    (jq, jk, jv), (q, k, v), tol = _inputs(8, d, dtype, b=2, h=4, sq=sq)
    sm = d ** -0.5
    ref = _run_jax(studies["bench_attn_multihead"].mh_attention, jq, jk, jv,
                   sm_scale=sm, bq=min(128, sq), bk=128, g=g)
    got = _untouched(sa.mh_attention, q, k, v, sm_scale=sm, g=g)
    _close(ref, got, tol)


@pytest.mark.parametrize("case,match", [
    ("rank", "must be"), ("skv", "must divide"), ("tile", "tile rows"),
    ("exp2", "needs fold_scale"), ("halves", "not built"),
    ("d160_bounded", "not built"), ("sub", "must divide")])
def test_wrappers_reject_bad_input(case, match):
    q = torch.zeros((1, 2, 128, 40))
    k = torch.zeros((1, 2, 256, 40))
    calls = {
        "rank": lambda: sa.tb_attention(q[0], k[0], k[0], sm_scale=1.0,
                                        bq=64, bk=64),
        "skv": lambda: sa.bnd2_attention(q, k[:, :, :200], k[:, :, :200],
                                         sm_scale=1.0),
        "tile": lambda: sa.t_attention(q, k, k, sm_scale=1.0, bq=1024,
                                       bk=64),
        "exp2": lambda: sa.variant_attention(q, k, k, sm_scale=1.0, bq=64,
                                             bk=64, fold_scale=False,
                                             use_exp2=True),
        "halves": lambda: sa.ablate_attention(q, k, k, sm_scale=1.0, bq=64,
                                              bk=64, do_exp=False,
                                              do_pv=False, halves=2),
        "d160_bounded": lambda: sa.bounded_attention(
            torch.zeros((1, 1, 64, 160)), torch.zeros((1, 1, 64, 160)),
            torch.zeros((1, 1, 64, 160)), sm_scale=1.0, bq=64, bk=64),
        "sub": lambda: sa.bounded_multi_attention(
            q, k[:, :, :192], k[:, :, :192], sm_scale=1.0, bq=64, bk=64,
            sub=2)}
    with pytest.raises(ValueError, match=match):
        calls[case]()


KINDS = {"TB": sa.TB, "BOUNDED": sa.BOUNDED, "QK": sa.QK,
         "QK_EXP": sa.QK_EXP, "QK_PV": sa.QK_PV, "BND2": sa.BND2}


def _sg_lines(name, lead=0, kinds=None):
    """The SG_BUILT / SG_TILES4 lines after a CUDA source's `extern "C"`,
    as tuples of ints (kind names through `kinds`); SG_TILES4 puts the
    four (bq, bk) tiles after its first `lead` arguments."""
    import re

    from storygen_tpu_torch.ops import _build
    src = (_build.CSRC / name).read_text()
    body = src[src.index('extern "C"'):]
    out = []
    pat = r"^\s*(SG_BUILT|SG_TILES4)\(([^)]*)\)\s*$"
    for macro, args in re.findall(pat, body, re.M):
        if any(a.strip().endswith("_") for a in args.split(",")):
            continue  # a line of a macro's own definition
        vals = tuple(kinds[a.strip()] if kinds and a.strip() in kinds
                     else int(a) for a in args.split(","))
        if macro == "SG_BUILT":
            out.append(vals)
        else:
            out += [vals[:lead] + (bq, bk) + vals[lead:]
                    for bq in sa.TILES for bk in sa.TILES]
    return out


def test_built_tables_match_the_cuda_sources():
    """The Python tables of built instantiations list exactly the keys of
    the CUDA sources' SG_BUILT lines: S1's and S2's (the wgmma lines carry
    two fields more, ring stages and panel columns; S2's BND2 lines are
    study_bnd2.cu's) and S3's and S4's (keys and line fields alike, each
    line once), every (bq, bk) of TILES for S3 in int8 and bf16 and for
    S4."""
    from storygen_tpu_torch.ops import study_int8
    assert {v[:5] for v in _sg_lines("study_online.cu")} == \
        set(sa.ONLINE_BUILT)
    bounded = (_sg_lines("study_bounded.cu", kinds=KINDS)
               + _sg_lines("study_bnd2.cu", kinds=KINDS))
    assert {v[:7] for v in bounded} == set(sa.BOUNDED_BUILT)
    for src, table in (("study_qk.cu", study_int8.QK_BUILT),
                       ("study_int8.cu", study_int8.INT8_BUILT)):
        lines = _sg_lines(src)
        assert len(lines) == len(table)
        assert {v[:4]: v[4:] for v in lines} == table
    tiles = {(bq, bk) for bq in sa.TILES for bk in sa.TILES}
    assert {(k[0], k[2], k[3]) for k in study_int8.QK_BUILT} == \
        {(i8,) + t for i8 in (0, 1) for t in tiles}
    assert {k[2:] for k in study_int8.INT8_BUILT} == tiles
    # the products' padded depths: int8 two k32 steps, bf16 three k16 ones;
    # S4's v_ext 41 -> 48 columns
    assert {k[1] for k in study_int8.QK_BUILT if k[0]} == {64}
    assert {k[1] for k in study_int8.QK_BUILT if not k[0]} == {48}
    assert {k[:2] for k in study_int8.INT8_BUILT} == {(64, 48)}


def test_study_wgmma_lines_match_the_tables():
    """Each S1 / S2 SG_BUILT line is one table entry, key and line fields
    (ring stages, Q / K panel columns) alike, once; S2's BND2 lines are
    all in study_bnd2.cu and the other kinds in study_bounded.cu, so the
    two build in parallel."""
    online = _sg_lines("study_online.cu")
    assert len(online) == len(sa.ONLINE_BUILT)
    assert {v[:5]: v[5:] for v in online} == sa.ONLINE_BUILT
    b1 = _sg_lines("study_bounded.cu", kinds=KINDS)
    b2 = _sg_lines("study_bnd2.cu", kinds=KINDS)
    assert len(b1) + len(b2) == len(sa.BOUNDED_BUILT)
    assert {v[:7]: v[7:] for v in b1 + b2} == sa.BOUNDED_BUILT
    assert all(v[6] != sa.BND2 for v in b1)
    assert all(v[6] == sa.BND2 for v in b2)


def test_study_lines_follow_f_or_the_smem_budget():
    """A study line takes F's unmasked line at the same (width, ring rows)
    where F has one and the line walks as F does, else the deepest ring of
    at most 4 stages that fits at the widest panel that lets one fit: no
    deeper ring and no wider panel of the same width fits a block. The
    walks that issue the next tile's Q K^T before the current tile's exps
    (split2; QK and QK_EXP, without V) take the budget's ring."""
    from storygen_tpu_torch.ops.flash_attention import FWD_BUILT
    f_lines = {(dp, v[1]): (v[2], v[3])
               for (dp, masked), v in FWD_BUILT.items() if not masked}
    rows = [(k[0], k[1], k[2], {}, k[4] == 2, v)
            for k, v in sa.ONLINE_BUILT.items()]
    for (dp, bq, bk, sub, halves, g, kind), v in sa.BOUNDED_BUILT.items():
        geo = sa.bounded_geometry(dp, bq, bk, sub, g, kind)
        rows.append((dp, 64 * geo["wgm"] // geo["split"], geo["rows"],
                     dict(v=geo["v"], split=geo["split"],
                          qslots=geo["qslots"]),
                     halves == 2 or not geo["v"], v))
    seen_f = ahead_at_f = 0
    for dp, qrows, ring_rows, kw, ahead, (stages, kpw) in rows:
        if (dp, ring_rows) in f_lines and ahead:
            ahead_at_f += 1
        elif (dp, ring_rows) in f_lines:
            assert (stages, kpw) == f_lines[(dp, ring_rows)]
            seen_f += 1
            continue
        assert 2 <= stages <= 4
        fits = lambda st, kp: sa.line_smem(  # noqa: E731
            dp, qrows, ring_rows, st, kp, **kw) <= sa.SMEM_LIMIT
        assert fits(stages, kpw)
        assert stages == 4 or not fits(stages + 1, kpw)
        assert all(not fits(2, wider) for wider in (64, 32)
                   if kpw < wider <= sa._PANEL[dp])
    assert seen_f >= 10 and ahead_at_f == 5


def test_ring_stages_match_the_cuda_header():
    """The Python mirror of the rings' depth is the header's rule: every
    study line's (S1-S4) shared memory is FwCfg::BYTES in
    flash_wgmma.cuh, whose stages each SG_BUILT line names; int8 Q / K
    (S3, S4) in rows of EB * KPW bytes, S4's kv scales in a 1 KB slot of
    each stage. The mma.sync ring rule (study_mma.cuh's ring_stages) is
    gone with S3's and S4's mma.sync rings."""
    from storygen_tpu_torch.ops import _build
    assert "ring_stages" not in (_build.CSRC / "study_mma.cuh").read_text()
    assert not hasattr(sa, "ring_stages")
    assert sa.SM_SMEM == 233472
    fw = (_build.CSRC / "flash_wgmma.cuh").read_text()
    for text in ("1024 + QSLOTS * QBYTES + STAGES * STAGE + HAND + BARS",
                 "STAGE = KBYTES + (V ? VBYTES : 0) + SKBYTES",
                 "SKBYTES = SK ? 1024 : 0",
                 "SK = EB == 1 && V",
                 "KRB = EB * KPW",
                 "KSTEPS = (EB * DP + 31) / 32",
                 "HAND = SPLIT > 1 ? 128 * (DP / 2 + 2) * 4 : 0",
                 "BARS = 8 * (QBARS + (V ? 4 : 2) * STAGES)",
                 "QBARS = QSLOTS > 1 ? 2 * QSLOTS : 1",
                 "VPW = DP % 32 == 0 ? 32 : 16"):
        assert text in fw, text
    # d 48 in one 64-column panel, 4 stages of 64 kv rows at bq 64
    assert sa.line_smem(48, 64, 64, 4, 64) == (
        1024 + 64 * 128 + 4 * (64 * 128 + 64 * 96) + 8 * (1 + 16))
    # g heads at d 160: two Q slots and the hand-over, 2 stages
    assert sa.line_smem(160, 64, 64, 2, 32, split=2, qslots=2) == (
        1024 + 2 * 5 * 64 * 64 + 2 * (5 * 64 * 64 + 64 * 320)
        + 128 * 82 * 4 + 8 * (4 + 8))


@pytest.mark.parametrize("table", ["online", "bounded", "qk", "int8"])
def test_every_built_study_ring_fits_a_block(table):
    """Each built S1-S4 instantiation's ring fits a block's shared memory,
    all on the wgmma template (line_smem at the line's stages and panels,
    at least two stages, Q in its own slots): S3 without V, its q_t slab
    (the products' padded depth in d rows of bq queries) inside the Q
    slot; S4 with V and its kv scales in every stage."""
    from storygen_tpu_torch.ops import study_int8 as si
    if table == "online":
        for (dp, bq, bk, _, halves), (st, kpw) in sa.ONLINE_BUILT.items():
            assert st >= 2
            smem = sa.line_smem(dp, bq, bk, st, kpw)
            assert smem == sa.online_smem(dp, bq, bk, halves)
            assert smem <= sa.SMEM_LIMIT
    elif table == "bounded":
        for key, (st, kpw) in sa.BOUNDED_BUILT.items():
            dp, bq, bk, sub, halves, g, kind = key
            geo = sa.bounded_geometry(dp, bq, bk, sub, g, kind)
            assert st >= 2
            smem = sa.line_smem(dp, 64 * geo["wgm"] // geo["split"],
                                geo["rows"], st, kpw, v=geo["v"],
                                split=geo["split"], qslots=geo["qslots"])
            assert smem == sa.bounded_smem(dp, bq, bk, sub, g, kind,
                                           halves), key
            assert smem <= sa.SMEM_LIMIT, key
    elif table == "qk":
        for (i8, dk, bq, bk), (st, kpw) in si.QK_BUILT.items():
            eb = 1 if i8 else 2
            assert st >= 2 and kpw == 64
            smem = sa.line_smem(48, bq, bk, st, kpw, v=False, eb=eb)
            assert smem == si.qk_smem(i8, bq, bk) <= sa.SMEM_LIMIT
            # the slab (QkCfg::SLAB): the products' padded depth in d rows
            # (64 int8, 48 bf16) of bq queries, inside the Q slot of bq
            # rows of eb * kpw bytes
            assert (64 if i8 else 48) * bq * eb <= bq * eb * kpw
            assert dk * eb in (64, 96)
    else:
        for (dk, dv, bq, bk), (st, kpw) in si.INT8_BUILT.items():
            assert st >= 2 and kpw == 64 and dk == 64
            smem = sa.line_smem(dv, bq, bk, st, kpw, eb=1)
            assert smem == si.int8_smem(bq, bk) <= sa.SMEM_LIMIT
            # BK fp32 kv scales inside the stage's 1 KB slot
            assert 4 * bk <= 1024
    # the widest: d = 160 at 128-row tiles (two stages of 32-column
    # panels), d = 160 + 1 (176) at 128-row tiles (16-column panels, the
    # only ones that fit two stages); the d = 40 tiles four stages of 64
    # rows
    assert sa.online_smem(160, 128, 128) == (
        1024 + 5 * 128 * 64 + 2 * (5 * 128 * 64 + 128 * 320) + 8 * 9)
    assert sa.BOUNDED_BUILT[(176, 128, 128, 1, 1, 1, sa.TB)] == (2, 16)
    assert sa.bounded_smem(176, 128, 128, 1, 1) == (
        1024 + 11 * 128 * 32 + 2 * (11 * 128 * 32 + 128 * 352) + 8 * 9)
    assert sa.ONLINE_BUILT[(48, 64, 64, sa.FOLDED_EXP2, 1)] == (4, 64)
    # S3 bf16 at 128 / 128: Q slot, four 128-row K stages of 128-byte rows;
    # int8 at 64 / 64: 64-byte rows
    assert si.qk_smem(0, 128, 128) == (
        1024 + 128 * 128 + 4 * 128 * 128 + 8 * (1 + 8))
    assert si.qk_smem(1, 64, 64) == 1024 + 64 * 64 + 4 * 64 * 64 + 8 * 9
    # S4 at 128 / 64: int8 Q, four stages of k8, v_ext (48 columns) and the
    # kv scales' 1 KB
    assert si.int8_smem(128, 64) == (
        1024 + 128 * 64 + 4 * (64 * 64 + 64 * 96 + 1024) + 8 * (1 + 16))


def test_int8_study_lines_follow_the_smem_budget():
    """S3's and S4's lines are study_line's: no F line (int8 Q / K, or no
    V), the deepest ring of at most 4 stages that fits a block at one
    64-byte panel (64 columns: int8 rows of 64 bytes, bf16 of 128)."""
    from storygen_tpu_torch.ops import study_int8 as si
    rows = [(bq, bk, dict(v=False, eb=1 if i8 else 2), line)
            for (i8, _, bq, bk), line in si.QK_BUILT.items()]
    rows += [(bq, bk, dict(eb=1), line)
             for (_, _, bq, bk), line in si.INT8_BUILT.items()]
    assert len(rows) == 12
    for bq, bk, kw, (stages, kpw) in rows:
        assert (stages, kpw) == sa.study_line(48, bq, bk, **kw)
        assert kpw == 64 and 2 <= stages <= 4
        fits = sa.line_smem(48, bq, bk, stages, kpw, **kw) <= sa.SMEM_LIMIT
        assert fits and (stages == 4 or sa.line_smem(
            48, bq, bk, stages + 1, kpw, **kw) > sa.SMEM_LIMIT)
    # an int8 line never takes a narrower panel (16 or 32 bytes a row)
    assert sa.study_line(48, 128, 128, eb=1)[1] == 64


def test_int8_tensor_maps():
    """S4's maps on (BH, S, D) int8 at a row pitch (study_maps with 1-byte
    elements): a 40-byte pitch is refused (TMA's strides are multiples of
    16 bytes, the size-1 head's too), 48 and 64 are taken; Q's map is D =
    40 wide, so its 64-byte box reads columns 40..63 as zeros, K's is the
    whole pitch; V the ones-extended 48 bf16 columns."""
    with pytest.raises(ValueError, match="multiples of 16"):
        sa.study_maps(2, 256, 512, 40, 128, 64, 64, eb=1, pitch=40)
    for pitch in (48, 64):
        maps = sa.study_maps(2, 256, 512, 40, 128, 64, 64, eb=1, pitch=pitch)
        assert maps["q"]["dims"] == (40, 1, 256, 2)
        assert maps["q"]["strides"] == (pitch, pitch, 256 * pitch)
        assert maps["q"]["box"] == (64, 1, 128, 1)
        assert maps["q"]["swizzle"] == 64
        assert maps["q"]["box"][0] - maps["q"]["dims"][0] == 24
        assert maps["k"]["dims"] == (pitch, 1, 512, 2)
        assert maps["k"]["strides"] == (pitch, pitch, 512 * pitch)
        assert maps["v"]["dims"] == (48, 1, 512, 2)
        assert maps["v"]["box"] == (16, 1, 64, 1)
    # a bf16 map with an explicit head stride is F's (B, S, H*D) one
    from storygen_tpu_torch.ops.flash_attention import operand_map
    assert operand_map((2, 64, 40), (64 * 48, 48, 1), 1, 64, 64, 1, 48)[
        "strides"] == (48, 48, 64 * 48)


def test_qk_k_layouts():
    """S3's k as the kernel reads it (study_int8._qk_k): int8 at 64 bytes a
    row is taken as it is and read 64 wide whatever its padding holds
    (it meets the slab's zero rows), any other int8 k (40-byte rows, a
    48-byte pitch) is copied at 64; a bf16 k whose rows end mid-sector
    (80 bytes) is copied into a zero-padded 48-column buffer read 48 wide,
    one of whole sectors is taken as it is, and a padded view whose
    padding the wrapper cannot vouch for is read D wide."""
    from storygen_tpu_torch.ops import study_int8 as si
    k8 = torch.arange(4 * 256 * 40, dtype=torch.int32).reshape(
        4, 256, 40).remainder(251).sub(125).to(torch.int8)
    kc, w = si._qk_k(k8, True)
    assert kc.stride() == (256 * 64, 64, 1) and w == 64
    assert torch.equal(kc, k8)
    assert kc.untyped_storage().nbytes() == 4 * 256 * 64
    assert torch.count_nonzero(
        torch.as_strided(kc, (4, 256, 24), (256 * 64, 64, 1), 40)) == 0
    for pitch in (48, 64):
        view = torch.full((4, 256, pitch), 3, dtype=torch.int8)[..., :40]
        got, w = si._qk_k(view, True)
        assert (got is view) == (pitch == 64) and w == 64
        assert got.stride() == (256 * 64, 64, 1) and torch.equal(got, view)
    kb = torch.randn(4, 256, 40).to(torch.bfloat16)
    kc, w = si._qk_k(kb, False)
    assert kc.stride() == (256 * 48, 48, 1) and w == 48
    assert torch.equal(kc, kb)
    got, w = si._qk_k(kc, False)
    assert got is kc and w == 40
    k48 = torch.randn(4, 256, 48).to(torch.bfloat16)
    got, w = si._qk_k(k48, False)
    assert got is k48 and w == 48


def _consumer_registers(dp, ns, sets, kind=sa.TB, sub=1):
    """A consumer thread's accumulator registers at its peak (fp32 O, the
    S sets in flight, P's bf16 pairs of the P V in flight): F's loop holds
    S_i and P_{i-1} (sets 1), split2 two S sets and P, the sub-tile loop
    every sub-tile's S and one P, QK / QK_EXP two S sets and no O."""
    if kind in (sa.QK, sa.QK_EXP):
        return 2 * ns // 2
    if sub > 1:
        return dp // 2 + sub * ns // 2 + ns // 4
    return dp // 2 + sets * ns // 2 + ns // 4


def _register_budget(wgm):
    """A consumer thread's registers: 255 with one consumer warpgroup
    (no setmaxnreg), else FwCfg::CONSUMER_REGS after setmaxnreg."""
    if wgm == 1:
        return 255
    regs = 512 // (wgm + 1) // 8 * 8
    return min((regs + (regs - 40) // wgm) // 8 * 8, 240)


@pytest.mark.parametrize("table", ["online", "bounded", "qk", "int8"])
def test_every_study_line_fits_its_registers(table):
    """Each S1-S4 line's accumulators at their peak leave 40 registers of
    a consumer thread's budget for addresses, the policy's row state and
    the walk (ptxas's own count is the smoke's; a spill fails it). S3
    holds two S sets (int32 or fp32) and its register A (two k32 or three
    k16 steps of 4 registers); S4 F's one S set, P and O."""
    from storygen_tpu_torch.ops import study_int8 as si
    rows = []
    if table == "online":
        for dp, bq, bk, _, halves in sa.ONLINE_BUILT:
            rows.append((bq // 64, _consumer_registers(dp, bk, halves)))
    elif table == "bounded":
        for dp, bq, bk, sub, halves, g, kind in sa.BOUNDED_BUILT:
            geo = sa.bounded_geometry(dp, bq, bk, sub, g, kind)
            rows.append((geo["wgm"], _consumer_registers(
                dp, geo["ns"], halves, kind, sub)))
    elif table == "qk":
        for i8, dk, bq, bk in si.QK_BUILT:
            rows.append((bq // 64, _consumer_registers(48, bk, 1, sa.QK)
                         + 4 * (2 if i8 else 3)))
    else:
        for dk, dv, bq, bk in si.INT8_BUILT:
            rows.append((bq // 64, _consumer_registers(dv, bk, 1, sa.INT8)))
    assert len(rows) >= (30 if table in ("online", "bounded") else 4)
    for wgm, regs in rows:
        assert regs + 40 <= _register_budget(wgm), (wgm, regs)
    assert _register_budget(1) == 255 and _register_budget(2) == 232


# (B, H, Sq, Skv, d) of chip_smoke.py's STUDY_SHAPES
STUDY_SHAPES = {"attn3 L1": (3, 8, 4096, 12288, 40),
                "attn1 L1": (6, 8, 4096, 4096, 40),
                "attn3 L2": (3, 8, 1024, 3072, 80),
                "attn3 L3": (3, 8, 256, 768, 160)}


def _map_checks(key, line, bh, sq, skv, w, table):
    """study_maps of one line at (BH, Sq, Skv, W): the boxes' shapes, the
    panels that cover the padded width and the zero-filled columns past
    W. Returns the zero-filled column count of a Q / K row."""
    dp, bq, bk = key[:3]
    stages, kpw = line
    if table == "online":
        qrows, rows, v = bq, bk, True
    else:
        geo = sa.bounded_geometry(*key[:4], key[5], key[6])
        qrows, rows, v = 64 * geo["wgm"] // geo["split"], geo["rows"], \
            geo["v"]
    maps = sa.study_maps(bh, sq, skv, w, qrows, rows, kpw, v)
    assert maps["q"]["dims"] == (w, 1, sq, bh)
    assert maps["k"]["dims"] == (w, 1, skv, bh)
    assert maps["q"]["strides"] == (2 * w, 2 * w, 2 * sq * w)
    assert maps["q"]["box"] == (kpw, 1, qrows, 1)
    assert maps["k"]["box"] == (kpw, 1, rows, 1)
    assert maps["q"]["swizzle"] == 2 * kpw
    # panels of kpw columns cover the padded width; what lies past W is
    # TMA's zero fill
    panels = -(-dp // kpw)
    assert panels * kpw >= dp >= w
    if v:
        vpw = sa.v_panel(dp)
        assert maps["v"]["box"] == (vpw, 1, rows, 1)
        assert dp % vpw == 0 and maps["v"]["swizzle"] == 2 * vpw
    else:
        assert "v" not in maps
    # the walk's whole tiles, every box row read
    assert sq % qrows == 0 and skv % rows == 0
    return panels * kpw - w


def _lines_at(dp):
    """(table, key, line, HBM width) of every built S1 / S2 line at the
    padded width dp: S1 and BND2 read q/k/v as they are (W = d), the other
    S2 kinds the extended ones (W = pad8(d + 1))."""
    out = []
    for key, line in sa.ONLINE_BUILT.items():
        if key[0] == dp:
            out.append(("online", key, line, {48: 40}.get(dp, dp)))
    for key, line in sa.BOUNDED_BUILT.items():
        if key[0] == dp:
            w = ({48: 40}.get(dp, dp) if key[6] == sa.BND2
                 else {48: 48, 96: 88, 176: 168}[dp])
            out.append(("bounded", key, line, w))
    return out


@pytest.mark.parametrize("dp", [48, 80, 96, 160, 176])
def test_study_tensor_maps_at_every_built_width(dp):
    """At every padded width the studies build, every line's tensor maps
    at a small shape: boxes of its panels and rows, panels that cover the
    width, and the columns past W that TMA fills with zeros (d 40: 24 of
    S1's 64-column panel; the extended 88 and 168: 8 and 24 or 8)."""
    lines = _lines_at(dp)
    assert lines
    zeros = set()
    for table, key, line, w in lines:
        g = key[5] if table == "bounded" else 1
        zeros.add(_map_checks(key, line, 2 * g, 256, 512, w, table))
    assert {48: {24, 16}, 80: {48}, 96: {8}, 160: {0}, 176: {24, 8}}[dp] \
        == zeros


@pytest.mark.parametrize("shape", list(STUDY_SHAPES))
def test_study_tensor_maps_at_the_study_shapes(shape):
    """Every S1 / S2 line at the width of a study shape, at that shape:
    its tensor maps, whole tiles, and a grid whose z dimension (BH, or BH
    / g) CUDA takes."""
    b, h, sq, skv, d = STUDY_SHAPES[shape]
    n = 0
    for dp in {sa.pad16(d), sa.pad16(sa.pad8(d + 1))}:
        for table, key, line, w in _lines_at(dp):
            if w not in (d, sa.pad8(d + 1)):
                continue
            g = key[5] if table == "bounded" else 1
            rows = key[2] * (key[3] if table == "bounded" else 1)
            if skv % rows or (b * h) % g:
                continue
            assert _map_checks(key, line, b * h, sq, skv, w, table) >= 0
            assert 0 < b * h // g <= 65535
            n += 1
    # attn3 L3 (d 160): S1's 8 lines, TB's 4 at 176 and mh's 3
    assert n >= 15


def test_study_tensor_map_rejects_what_tma_cannot_read():
    """A width that 8 does not divide has rows that are no multiple of 16
    bytes apart: no tensor map (the wrappers pad the extended q/k/v to 8
    columns for this)."""
    with pytest.raises(ValueError, match="multiples of 16"):
        sa.study_maps(2, 256, 512, 41, 64, 64, 64)
    with pytest.raises(ValueError, match="TMA's rules"):
        sa.study_maps(2, 512, 512, 48, 512, 64, 64)


def _head_walk(g: int, nt: int, stages: int) -> list:
    """The order in which an S2 block of g heads lands and walks its K/V
    tiles (csrc/study_wgmma.cuh::s2_start, s2_heads): (head, tile, ring
    stage, the parity of that stage's fill the consumers wait for, Q slot,
    the parity of that slot's fill), the ring running on across heads."""
    return [(hd, t, (hd * nt + t) % stages, ((hd * nt + t) // stages) & 1,
             hd % 2, (hd // 2) & 1) for hd in range(g) for t in range(nt)]


def _kv_split(dp: int, bk: int, g: int) -> list:
    """The kv rows of each tile that each consumer warpgroup of a g-heads
    block takes, [(first row, rows)] (s2_heads: warpgroup w takes rows w
    NS .. of each tile, NS = bounded_geometry's `ns`)."""
    geo = sa.bounded_geometry(dp, 64, bk, 1, g, sa.BND2)
    return [(w * geo["ns"], geo["ns"]) for w in range(geo["split"])]


@pytest.mark.parametrize("g", [2, 4, 8])
def test_mh_head_walk_and_kv_split(g):
    """A g-heads block walks each (head, tile) once, head by head; the
    ring runs on across heads (a stage is refilled only after the
    consumers released its previous fill, whose parity differs), Q
    alternates between two slots, and at d 80 / 160 two warpgroups split
    every tile's 64 kv rows into halves whose descriptors start on a
    swizzle period; at d 40 one warpgroup takes the tile."""
    for dp, nt in ((48, 64), (80, 48), (160, 12)):
        stages, kpw = sa.BOUNDED_BUILT[(dp, 64, 64, 1, 1, g, sa.BND2)]
        walk = _head_walk(g, nt, stages)
        assert [(hd, t) for hd, t, *_ in walk] == \
            [(hd, t) for hd in range(g) for t in range(nt)]
        for i, (hd, t, st, par, slot, qpar) in enumerate(walk):
            assert st == i % stages and par == (i // stages) & 1
            if i >= stages:  # the previous fill of this stage
                assert walk[i - stages][2] == st
                assert walk[i - stages][3] != par
            assert slot == hd % 2 and qpar == (hd // 2) & 1
        split = _kv_split(dp, 64, g)
        assert sum(n for _, n in split) == 64
        assert [f for f, _ in split] == [sum(n for _, n in split[:i])
                                         for i in range(len(split))]
        assert len(split) == (1 if dp == 48 else 2)
        for first, ns in split:
            assert ns % 16 == 0 and ns % 8 == 0 and ns <= 256
            assert (first * 2 * kpw) % 1024 == 0
        # two Q slots: the next head's Q lands while the current one runs
        assert sa.bounded_geometry(dp, 64, 64, 1, g, sa.BND2)["qslots"] == 2


def test_multihead_study_sweeps_only_built_lines():
    """Every (d, g) that bench_attn_multihead sweeps, at its default 64-row
    tiles, is a built S2 line, g = 8 at d = 160 included."""
    from storygen_tpu_torch.studies import bench_attn_multihead, common
    for _, _, _, _, _, d in common.shapes(bench_attn_multihead.MAIN_SHAPES):
        for g in bench_attn_multihead.GROUPS:
            assert (sa.pad16(d), 64, 64, 1, 1, g, sa.BND2) in \
                sa.BOUNDED_BUILT, (d, g)
    assert {common.SHAPES[s][4] for s in bench_attn_multihead.MAIN_SHAPES} \
        == {40, 80, 160}


# the ported study entry points: (module, function, lines printed for one
# shape, each ending with the device line)
TINY = ("tiny", 1, 8, 128, 256, 40)
STUDY_RUNS = [
    ("bench_attn_variants", "main", 6), ("bench_attn_variants", "sweep", 4),
    ("bench_attn_v2", "main", 14), ("bench_attn_scan", "main", 6),
    ("bench_attn_scan", "main_bounded", 4),
    ("bench_attn_scan", "main_pair", 4),
    ("bench_attn_ablate", "main", 11), ("bench_attn_bnd2", "main", 5),
    ("bench_attn_multihead", "main", 4), ("bench_attn_int8", "main", 13),
    ("bench_attn_int8_epilogue", "main", 3)]


@pytest.mark.parametrize("module,fn,lines", STUDY_RUNS)
def test_study_entry_points_run_on_the_cpu(module, fn, lines, capsys):
    study = importlib.import_module(f"storygen_tpu_torch.studies.{module}")
    getattr(study, fn)(device="cpu", shapes=[TINY], iters=1)
    out = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.endswith("[cpu host clock]")]
    assert len(out) == lines, out
    assert not any("FAILED" in ln for ln in out), out


@pytest.mark.parametrize("module,fn", [r[:2] for r in STUDY_RUNS])
def test_study_entry_points_need_a_card_unless_asked(module, fn,
                                                     monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    study = importlib.import_module(f"storygen_tpu_torch.studies.{module}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(study, fn)(shapes=[TINY], iters=1)
