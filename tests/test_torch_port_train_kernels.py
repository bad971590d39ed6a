"""Port parity for the training slice's kernels, on CPU tensors, i.e. their
plain PyTorch versions behind the port's autograd Functions, against the
JAX package, fp32, tolerance 1e-4 (tests/torch_port_util.py):

- masked forward (M) and the backward (L, DQ, DKV) through
  FlashAttentionFn, against the Pallas flash attention with a block mask
  under jax.grad, run in interpret mode as tests/test_pallas_attention.py
  runs it (its backward is _lse_kernel/_dq_kernel/_dkv_kernel);
- attn2's ragged 77-token kv, which no Pallas block tiles, against jax.grad
  of the XLA attention;
- Conv3x3Fn and GegluMatmulFn against jax.vjp of pallas_conv.conv3x3 and
  pallas_geglu.geglu_matmul (interpret mode).
The CUDA kernels themselves run only on the card (chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storygen_tpu.ops.attention import xla_attention
from storygen_tpu.ops.pallas_attention import flash_attention as j_flash
from storygen_tpu.ops.pallas_conv import conv3x3 as j_conv3x3
from storygen_tpu.ops.pallas_geglu import geglu_matmul as j_geglu
from storygen_tpu_torch.ops import conv, flash_attention as fa, geglu
from tests.torch_port_util import assert_close, rand, t

H = 2


def _seq(x):
    """(B, H, S, D) numpy -> the port's (B, S, H*D) tensor, requiring grad."""
    b, h, s, d = x.shape
    return t(x).transpose(1, 2).reshape(b, s, h * d).requires_grad_()


def _bhsd(x, h=H):
    """The port's (B, S, H*D) -> (B, H, S, D) numpy."""
    b, s, hd = x.shape
    return x.detach().reshape(b, s, h, hd // h).transpose(1, 2).numpy()


def _port_grads(q, k, v, g, d, keep=None):
    qt, kt, vt = _seq(q), _seq(k), _seq(v)
    launches = (fa.flash_fwd.launches, fa.flash_fwd_masked.launches,
                fa.flash_lse.launches, fa.flash_dq.launches,
                fa.flash_dkv.launches)
    out = fa.flash_attention(qt, kt, vt, H, d ** -0.5,
                             None if keep is None else torch.tensor(keep))
    (out * _seq(g).detach()).sum().backward()
    # CPU tensors: every wrapper ran its plain version, no kernel
    assert launches == (fa.flash_fwd.launches, fa.flash_fwd_masked.launches,
                        fa.flash_lse.launches, fa.flash_dq.launches,
                        fa.flash_dkv.launches)
    return _bhsd(out), _bhsd(qt.grad), _bhsd(kt.grad), _bhsd(vt.grad)


def _jax_grads(fn, q, k, v, g):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (out,) + vjp(jnp.asarray(g))


@pytest.mark.parametrize("variant", ["bnd_guard", "online_t"])
@pytest.mark.parametrize("keep", [[[0, 1, 1], [0, 0, 1]],   # first dropped
                                  [[1, 0, 1], [1, 1, 1]]])
def test_masked_flash_and_backward_match_pallas(keep, variant):
    b, sq, span, d = 2, 128, 128, 16
    q, k, v = (rand(s, (b, H, n, d)) for s, n in ((20, sq), (21, 3 * span),
                                                   (22, 3 * span)))
    g = rand(23, (b, H, sq, d))
    ref = _jax_grads(lambda q, k, v: j_flash(
        q, k, v, scale=d ** -0.5, block_q=128, block_k=128, interpret=True,
        variant=variant, block_mask=jnp.asarray(keep, jnp.float32)),
        q, k, v, g)
    got = _port_grads(q, k, v, g, d, keep)
    for name, r, p in zip(("out", "dq", "dk", "dv"), ref, got):
        assert_close(r, p, msg=name)
    # a dropped span gets no gradient
    for bi, row in enumerate(keep):
        for j, kept in enumerate(row):
            if not kept:
                sl = slice(j * span, (j + 1) * span)
                assert not got[2][bi, :, sl].any()
                assert not got[3][bi, :, sl].any()


def test_unmasked_backward_matches_pallas():
    b, sq, skv, d = 2, 128, 256, 16
    q, k, v = (rand(s, (b, H, n, d)) for s, n in ((30, sq), (31, skv),
                                                   (32, skv)))
    g = rand(33, (b, H, sq, d))
    ref = _jax_grads(lambda q, k, v: j_flash(
        q, k, v, scale=d ** -0.5, block_q=128, block_k=128, interpret=True),
        q, k, v, g)
    for name, r, p in zip(("out", "dq", "dk", "dv"), ref,
                          _port_grads(q, k, v, g, d)):
        assert_close(r, p, msg=name)


def test_ragged_text_kv_backward_matches_xla():
    """attn2: 77 text tokens of kv."""
    b, sq, skv, d = 2, 64, 77, 40
    q, k, v = (rand(s, (b, H, n, d)) for s, n in ((40, sq), (41, skv),
                                                   (42, skv)))
    g = rand(43, (b, H, sq, d))
    ref = _jax_grads(lambda q, k, v: xla_attention(q, k, v, d ** -0.5),
                     q, k, v, g)
    for name, r, p in zip(("out", "dq", "dk", "dv"), ref,
                          _port_grads(q, k, v, g, d)):
        assert_close(r, p, msg=name)


def test_row_that_keeps_no_ref_gives_zeros():
    """Never drawn in training (the newest ref is always kept), but pinned:
    a batch row whose every span is dropped attends to nothing, so its
    output and all its gradients are 0; the other rows are unaffected."""
    b, sq, span, d = 2, 32, 64, 16
    keep = [[0, 0, 0], [1, 0, 1]]
    q, k, v = (rand(s, (b, H, n, d)) for s, n in ((50, sq), (51, 3 * span),
                                                   (52, 3 * span)))
    g = rand(53, (b, H, sq, d))
    out, dq, dk, dv = _port_grads(q, k, v, g, d, keep)
    for x in (out, dq, dk, dv):
        assert np.isfinite(x).all() and not x[0].any()
    mask = jnp.repeat(jnp.asarray(keep[1:], bool), span,
                      axis=1)[:, None, None, :]
    ref = _jax_grads(lambda q, k, v: xla_attention(q, k, v, d ** -0.5,
                                                   mask=mask),
                     q[1:], k[1:], v[1:], g[1:])
    for name, r, p in zip(("out", "dq", "dk", "dv"), ref,
                          (out, dq, dk, dv)):
        assert_close(r, p[1:], msg=name)
    lse = fa.flash_lse(_seq(q).detach(), _seq(k).detach(), H, d ** -0.5,
                       torch.tensor(keep))
    assert torch.isneginf(lse[0]).all() and torch.isfinite(lse[1]).all()


@pytest.mark.parametrize("per_batch_bias", [True, False])
@pytest.mark.parametrize("need_weight", [True, False])
def test_conv3x3_fn_matches_jax_vjp(per_batch_bias, need_weight):
    b, h, w, cin, cout = 2, 16, 16, 8, 16
    x, k = rand(60, (b, h, w, cin)), rand(61, (3, 3, cin, cout), 0.1)
    bias = rand(62, (b, cout) if per_batch_bias else (cout,))
    r, g = rand(63, (b, h, w, cout)), rand(64, (b, h, w, cout))
    out_j, vjp = jax.vjp(lambda x, k, bb: j_conv3x3(x, k, bb, 8, True),
                         jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias))
    dx_j, dk_j, db_j = vjp(jnp.asarray(g))

    xt, bt, rt = (t(a).requires_grad_() for a in (x, bias, r))
    w_oihw = t(k).permute(3, 2, 0, 1).contiguous().requires_grad_(
        need_weight)
    before = conv.conv3x3.launches
    out = conv.Conv3x3Fn.apply(xt, conv.pack_weight(w_oihw, torch.float32),
                               bt, rt)
    (out * t(g)).sum().backward()
    assert conv.conv3x3.launches == before  # CPU: plain version
    assert_close(np.asarray(out_j) + r, out, msg="out")
    assert_close(dx_j, xt.grad, msg="dx")
    assert_close(db_j, bt.grad, msg="db")
    np.testing.assert_array_equal(rt.grad.numpy(), g)  # the residual's
    if need_weight:
        assert_close(dk_j, w_oihw.grad.permute(2, 3, 1, 0), msg="dw")
    else:
        assert w_oihw.grad is None


def test_conv3x3_module_packs_differentiably_or_caches():
    from storygen_tpu_torch.models.layers import Conv3x3
    m = Conv3x3(4, 6)
    torch.nn.init.normal_(m.weight)
    x = t(rand(66, (1, 8, 8, 4)))
    m(x).sum().backward()  # the weight requires grad: packed in the graph
    assert m.weight.grad is not None and m.weight.grad.abs().sum() > 0
    with torch.no_grad():  # no gradient can flow: packed once, cached
        assert m.packed_weight(torch.float32) is \
            m.packed_weight(torch.float32)
    m.weight.requires_grad_(False)
    first = m.packed_weight(torch.float32)
    assert m.packed_weight(torch.float32) is first
    with torch.no_grad():
        m.weight.add_(1.0)  # a new weight version is packed anew
    assert not torch.equal(m.packed_weight(torch.float32), first)


def test_flip_weight_is_the_transposed_conv():
    k = rand(65, (3, 3, 4, 6))
    w9 = conv.pack_weight(t(k).permute(3, 2, 0, 1), torch.float32)
    flipped = k[::-1, ::-1].transpose(0, 1, 3, 2).reshape(9, 6, 4)
    np.testing.assert_array_equal(conv.flip_weight(w9).numpy(), flipped)


@pytest.mark.parametrize("need_wb", [True, False])
def test_geglu_fn_matches_jax_vjp(need_wb):
    m, n, e = 256, 512, 320
    proj, w = rand(70, (m, 2 * n)), rand(71, (n, e), 0.02)
    bias, g = rand(72, (e,)), rand(73, (m, e))
    out_j, vjp = jax.vjp(lambda p, ww, bb: j_geglu(p, ww, bb, True),
                         jnp.asarray(proj), jnp.asarray(w), jnp.asarray(bias))
    dp_j, dw_j, db_j = vjp(jnp.asarray(g))

    pt = t(proj).requires_grad_()
    wt = t(w).t().contiguous().requires_grad_(need_wb)
    bt = t(bias).requires_grad_(need_wb)
    before = geglu.geglu_matmul.launches
    out = geglu.GegluMatmulFn.apply(pt, wt, bt)
    (out * t(g)).sum().backward()
    assert geglu.geglu_matmul.launches == before  # CPU: plain version
    assert_close(out_j, out, msg="out")
    assert_close(dp_j, pt.grad, msg="dproj")
    if need_wb:
        assert_close(dw_j, wt.grad.t(), msg="dw")
        assert_close(db_j, bt.grad, msg="db")
    else:
        assert wt.grad is None and bt.grad is None
