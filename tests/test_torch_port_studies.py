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


def test_built_tables_match_the_cuda_sources():
    """The Python tables of built instantiations list exactly the SG_BUILT
    and SG_TILES4 lines of the CUDA sources."""
    import re

    from storygen_tpu_torch.ops import _build, study_int8

    def parse(name, lead, kinds=None):
        """SG_TILES4 puts the four (bq, bk) tiles after its first `lead`
        arguments."""
        src = (_build.CSRC / name).read_text()
        body = src[src.index('extern "C"'):]
        out = set()
        pat = r"^\s*(SG_BUILT|SG_TILES4)\(([^)]*)\)\s*$"
        for macro, args in re.findall(pat, body, re.M):
            if any(a.strip().endswith("_") for a in args.split(",")):
                continue  # a line of a macro's own definition
            vals = tuple(kinds[a.strip()] if kinds and a.strip() in kinds
                         else int(a) for a in args.split(","))
            if macro == "SG_BUILT":
                out.add(vals)
            else:
                out |= {vals[:lead] + (bq, bk) + vals[lead:]
                        for bq in sa.TILES for bk in sa.TILES}
        return out

    kinds = {"TB": sa.TB, "BOUNDED": sa.BOUNDED, "QK": sa.QK,
             "QK_EXP": sa.QK_EXP, "QK_PV": sa.QK_PV, "BND2": sa.BND2}
    assert parse("study_online.cu", 1) == sa.ONLINE_BUILT
    assert parse("study_bounded.cu", 1, kinds) == sa.BOUNDED_BUILT
    assert parse("study_qk.cu", 2) == study_int8.QK_BUILT
    assert parse("study_int8.cu", 2) == study_int8.INT8_BUILT


def test_ring_stages_match_the_cuda_header():
    """The Python mirror of the K/V ring's depth is the header's rule."""
    from storygen_tpu_torch.ops import _build
    src = (_build.CSRC / "study_mma.cuh").read_text()
    assert "return 2 * (3 * stage + 1024) <= 233472 ? 3 : 2;" in src
    assert sa.SM_SMEM == 233472
    assert [sa.ring_stages(b) for b in (1000, 38570, 38571, 100000)] == \
        [3, 3, 2, 2]


@pytest.mark.parametrize("table", ["online", "bounded", "qk", "int8"])
def test_every_built_study_ring_fits_a_block(table):
    """Each built S1-S4 instantiation's ring (two or three stages, by
    ring_stages) fits a block's shared memory, beside S3's q_t slab; where
    Q is copied into a stage (S1, one-head S2, S4), its tile fits one
    stage."""
    from storygen_tpu_torch.ops import study_int8 as si
    rows = []  # (smem, one stage's bytes, bytes beside the ring, Q tile)
    if table in ("online", "bounded"):
        for key in (sa.ONLINE_BUILT if table == "online"
                    else sa.BOUNDED_BUILT):
            dp, bq, bk = key[:3]
            sub, g = (1, 1) if table == "online" else (key[3], key[5])
            pitch = sa.pitch_bytes(2 * dp)
            q = sa.align128(bq * pitch)
            rows.append((sa.online_smem(dp, bq, bk) if table == "online"
                         else sa.bounded_smem(dp, bq, bk, sub, g),
                         2 * sa.align128(sub * bk * pitch)
                         + (q if g > 1 else 0), 0, q))
    elif table == "qk":
        for i8, dp, bq, bk in si.QK_BUILT:
            # int8 K rows dense, bf16 at an ldmatrix pitch
            eb = 1 if i8 else 2
            kpitch = dp if i8 else sa.pitch_bytes(2 * dp)
            rows.append((si.qk_smem(i8, dp, bq, bk), sa.align128(bk * kpitch),
                         sa.align128(dp * sa.pitch_bytes(bq * eb)), 0))
    else:
        for dp8, dv, bq, bk in si.INT8_BUILT:
            rows.append((si.int8_smem(dp8, dv, bq, bk),
                         sa.align128(bk * dp8)
                         + sa.align128(bk * sa.pitch_bytes(2 * dv))
                         + sa.align128(bk * 4), 0,
                         sa.align128(bq * sa.pitch_bytes(dp8))))
    assert len(rows) >= 4
    for smem, stage, beside, q in rows:
        assert smem == beside + sa.ring_stages(stage) * stage
        assert smem <= sa.SMEM_LIMIT, (table, smem)
        assert q <= stage
    # the widest: d = 160 (176 with the extended column) at 128-row tiles
    # takes two stages, the d = 40 tiles three; S3 / S4's small stages
    # three
    assert sa.online_smem(160, 128, 128) == 2 * 2 * 128 * 336
    assert sa.bounded_smem(176, 128, 128, 1, 1) == 2 * 2 * 128 * 368
    assert sa.online_smem(48, 64, 64) == 3 * 2 * 64 * 112
    assert si.qk_smem(0, 48, 128, 128) == 48 * 272 + 3 * 128 * 112
    assert si.int8_smem(48, 48, 128, 64) == 3 * (64 * 48 + 64 * 112 + 256)


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
