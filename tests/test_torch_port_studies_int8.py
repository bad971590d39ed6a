"""Port parity for the int8 study kernels (ops/study_int8.py): qk_only,
full_int8 and int8_attn_from_quant on CPU tensors, i.e. their plain
PyTorch versions, against the Pallas kernels of
scripts/studies/bench_attn_int8.py and bench_attn_int8_epilogue.py run in
TPU interpret mode, on the same seeded numpy inputs; and the host
quantisation (quant_rows, quant_heads) against JAX's, which it must match
exactly. The int8 column sum within 1e-6 of the largest magnitude (integer
work summed in fp32), the attention outputs within 1e-4 (fp32 v) or 1e-2
(bf16 v) of it."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from storygen_tpu_torch.ops import study_int8 as si
from tests.torch_port_util import rand

BH, D, SQ, SKV = 2, 40, 256, 512


@pytest.fixture(scope="module")
def studies():
    """The JAX int8 study modules, with tests/conftest.py's compilation
    cache settings put back after their import."""
    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    mods = {n: importlib.import_module(f"scripts.studies.{n}") for n in (
        "bench_attn_int8", "bench_attn_int8_epilogue")}
    for k, v in keep.items():
        jax.config.update(k, v)
    return mods


def _run_jax(fn, *args, **kw):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*args, **kw).astype(jnp.float32))


def _close(ref, got, rel):
    got = got.float().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    err, bound = np.abs(got - ref).max(), rel * np.abs(ref).max()
    assert err <= bound, (err, bound)


def _untouched(fn, *args, **kw):
    before = [w.launches for w in si.WRAPPERS]
    out = fn(*args, **kw)
    assert [w.launches for w in si.WRAPPERS] == before
    return out


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("int8", [True, False])
def test_qk_only(studies, int8, layout):
    """`strided`: the torch side's k is a view of a wider buffer whose
    columns past D hold other values (the kernel's map reads them only
    where they meet zeros)."""
    q_t = rand(1, (BH, D, SQ))
    k = rand(2, (BH, SKV, D))
    if int8:
        q_t, k = (np.clip(np.round(x * 32), -127, 127).astype(np.int8)
                  for x in (q_t, k))
        jq, jk = jnp.asarray(q_t), jnp.asarray(k)
        tq, tk = torch.from_numpy(q_t), torch.from_numpy(k)
    else:
        jq, jk = jnp.asarray(q_t, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
        tq, tk = (torch.from_numpy(x).to(torch.bfloat16) for x in (q_t, k))
    if layout == "strided":
        wide = torch.full((BH, SKV, 64), 7, dtype=tk.dtype)
        wide[..., :D] = tk
        tk = wide[..., :D]
        assert tk.stride() == (SKV * 64, 64, 1)
    ref = _run_jax(studies["bench_attn_int8"].qk_only, jq, jk, bq=128,
                   bk=128, int8=int8)
    got = _untouched(si.qk_only, tq, tk, bq=64, bk=128, int8=int8)
    _close(ref, got, 1e-6 if int8 else 1e-2)


@pytest.mark.parametrize("dtype,tol", [("bf16", 1e-2), ("fp32", 1e-4)])
def test_full_int8(studies, dtype, tol):
    arrs = [rand(3 + i, (1, 2, SQ if i == 0 else SKV, D)) for i in range(3)]
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    sm = D ** -0.5
    ref = _run_jax(studies["bench_attn_int8"].full_int8,
                   *(jnp.asarray(a, jd) for a in arrs), sm_scale=sm, bq=128,
                   bk=128)
    got = _untouched(si.full_int8, *(torch.from_numpy(a).to(td)
                                     for a in arrs), sm_scale=sm, bq=128,
                     bk=64)
    _close(ref, got, tol)


def test_int8_attn_from_quant(studies):
    """q and k quantised after the projections, as the epilogue study does
    (per-(row, head) over each head's segment), then the int8 kernel."""
    ep = studies["bench_attn_int8_epilogue"]
    b, h, sq, skv, d = 1, 2, SQ, SKV, D
    y_q, y_k = rand(6, (b * sq, h * d)), rand(7, (b * skv, h * d))
    v = rand(8, (b, h, skv, d))
    sm = d ** -0.5

    def heads(x, s):  # (B*S, H, ...) -> (B, H, S, ...), JAX or torch
        x = x.reshape(b, s, h, -1)
        return (x.permute(0, 2, 1, 3) if torch.is_tensor(x)
                else x.transpose(0, 2, 1, 3))

    jq8, jsq = ep.quant_heads(jnp.asarray(y_q, jnp.bfloat16), h, d)
    jk8, jsk = ep.quant_heads(jnp.asarray(y_k, jnp.bfloat16), h, d)
    ref = _run_jax(ep.int8_attn_from_quant, heads(jq8, sq),
                   heads(jsq, sq)[..., 0], heads(jk8, skv),
                   heads(jsk, skv)[..., 0], jnp.asarray(v, jnp.bfloat16),
                   sm_scale=sm, bq=128, bk=128)
    q8, sqs = si.quant_heads(torch.from_numpy(y_q).to(torch.bfloat16), h, d)
    k8, sks = si.quant_heads(torch.from_numpy(y_k).to(torch.bfloat16), h, d)
    got = _untouched(si.int8_attn_from_quant, heads(q8, sq),
                     heads(sqs, sq)[..., 0], heads(k8, skv),
                     heads(sks, skv)[..., 0],
                     torch.from_numpy(v).to(torch.bfloat16), sm_scale=sm,
                     bq=64, bk=64)
    _close(ref, got, 1e-2)


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_quant_heads_and_rows_match_jax_exactly(studies, dtype):
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    y = rand(9, (64, 4 * D), 3.0)
    j8, js = studies["bench_attn_int8_epilogue"].quant_heads(
        jnp.asarray(y, jd), 4, D)
    t8, ts = si.quant_heads(torch.from_numpy(y).to(td), 4, D)
    assert t8.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # full_int8's own per-row quantisation, as written in the study
    xf = jnp.asarray(y, jd).astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True) + 1e-12
    r8, rs = si.quant_rows(torch.from_numpy(y).to(td))
    np.testing.assert_array_equal(
        r8.numpy(), np.asarray(jnp.round(xf / amax * 127.0).astype(jnp.int8)))
    np.testing.assert_array_equal(rs.numpy(),
                                  np.asarray(amax[..., 0] / 127.0))


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_quant_rows_at_the_kernels_pitch(dtype):
    """quant_rows with a pitch writes the same int8 rows straight into a
    zero buffer of that many bytes a row (the kernels' pad32(D) = 64 at
    d 40): equal to quant_rows on the first D bytes, zeros after, the
    same scales; int8_rows takes such a tensor as it is and copies any
    other into one."""
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    x = torch.from_numpy(rand(10, (2, 3, 96, D), 2.0)).to(td)
    ref8, refs = si.quant_rows(x)
    got8, gots = si.quant_rows(x, 64)
    assert got8.shape == ref8.shape and got8.stride() == (3 * 96 * 64,
                                                          96 * 64, 64, 1)
    assert torch.equal(got8, ref8) and torch.equal(gots, refs)
    pad = torch.as_strided(got8, (2, 3, 96, 64 - D), got8.stride(), D)
    assert torch.count_nonzero(pad) == 0
    assert si.int8_rows(got8) is got8
    copied = si.int8_rows(ref8)
    assert copied is not ref8 and torch.equal(copied, ref8)
    assert copied.stride() == got8.stride()


@pytest.mark.parametrize("case,match", [
    ("rank", "must be"), ("dtype", "takes"), ("skv", "must divide"),
    ("not_built", "not built"), ("attn_dtype", "int8")])
def test_int8_wrappers_reject_bad_input(case, match):
    q_t = torch.zeros((2, 40, 128), dtype=torch.int8)
    k = torch.zeros((2, 256, 40), dtype=torch.int8)
    x = torch.zeros((1, 2, 128, 40))
    calls = {
        "rank": lambda: si.qk_only(q_t[0], k[0], bq=64, bk=64, int8=True),
        "dtype": lambda: si.qk_only(q_t.float(), k.float(), bq=64, bk=64,
                                    int8=True),
        "skv": lambda: si.qk_only(q_t, k[:, :200], bq=64, bk=64, int8=True),
        "not_built": lambda: si.full_int8(
            torch.zeros((1, 2, 128, 80)), torch.zeros((1, 2, 256, 80)),
            torch.zeros((1, 2, 256, 80)), sm_scale=1.0, bq=64, bk=64),
        "attn_dtype": lambda: si.int8_attn_from_quant(
            x, x[..., 0], x, x[..., 0], x, sm_scale=1.0, bq=64, bk=64)}
    with pytest.raises(ValueError, match=match):
        calls[case]()
