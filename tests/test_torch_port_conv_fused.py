"""Port parity for the fused-conv configuration (configs.ConvKernels): the
wrappers of kernels P (`gnconv3x3`) and D (`downconv3x3`) on CPU tensors,
i.e. their plain PyTorch versions, and their autograd Functions, against the
JAX Pallas kernels they replace run in interpret mode as
tests/test_pallas_conv.py runs them; GroupNorm.fold and the resnet and
downsamplers built in that configuration, against the JAX modules. fp32,
tolerance 1e-4 (tests/torch_port_util.py). The CUDA kernels themselves run
only on the card (chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storygen_tpu.models import layers as JL
from storygen_tpu.models import vae as JV
from storygen_tpu.ops.pallas_conv import (downconv3x3 as j_downconv3x3,
                                          gnconv3x3 as j_gnconv3x3,
                                          gnconvres3x3 as j_gnconvres3x3,
                                          halo_conv, halo_downconv)
from storygen_tpu_torch.checkpoint.convert import VAE_REWRITES
from storygen_tpu_torch.configs import ConvKernels
from storygen_tpu_torch.models import layers as TL
from storygen_tpu_torch.models import vae as TV
from storygen_tpu_torch.ops import conv, downconv
from tests.torch_port_util import assert_close, load, rand, t

RNG = jax.random.PRNGKey(0)
FUSED = ConvKernels(fused_prologue=True, strided=True)
PADS = [((1, 1), (1, 1)), ((0, 1), (0, 1))]  # the UNet's, the VAE's


def _w9(k):
    """JAX HWIO (3, 3, Cin, Cout) -> the port's packed (9, Cin, Cout)."""
    return conv.pack_weight(t(k).permute(3, 2, 0, 1), torch.float32)


def _affine(seed, b, c):
    """a > 0 and s nonzero everywhere: silu(s) != 0 at the SAME border, so
    an unmasked border would show."""
    return rand(seed, (b, c), 0.5) + 1.0, rand(seed + 1, (b, c))


def _launches():
    return conv.gnconv3x3.launches, downconv.downconv3x3.launches


@pytest.mark.parametrize("per_batch_bias,residual", [
    (False, False), (True, False), (False, True), (True, True)])
def test_gnconv3x3_matches_halo_conv_prologue(per_batch_bias, residual):
    b, h, w, cin, cout = 2, 16, 16, 8, 16
    x, k = rand(1, (b, h, w, cin)), rand(2, (3, 3, cin, cout), 0.1)
    a, s = _affine(3, b, cin)
    bias = rand(5, (b, cout) if per_batch_bias else (cout,))
    r = rand(6, (b, h, w, cout)) if residual else None
    ref = halo_conv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                    block_h=8, interpret=True,
                    prologue=(jnp.asarray(a), jnp.asarray(s)),
                    residual=None if r is None else jnp.asarray(r))
    before = _launches()
    out = conv.gnconv3x3(t(x), _w9(k), t(bias), t(a), t(s),
                         None if r is None else t(r))
    assert _launches() == before  # CPU: plain version
    assert_close(ref, out)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("per_batch_bias", [False, True])
def test_gnconv3x3_fn_matches_jax_vjp(per_batch_bias, residual):
    b, h, w, cin, cout = 2, 16, 8, 8, 16
    x, k = rand(10, (b, h, w, cin)), rand(11, (3, 3, cin, cout), 0.1)
    a, s = _affine(12, b, cin)
    bias = rand(14, (b, cout) if per_batch_bias else (cout,))
    r, g = rand(15, (b, h, w, cout)), rand(16, (b, h, w, cout))
    args = [jnp.asarray(v) for v in (x, a, s, k, bias)]
    if residual:
        out_j, vjp = jax.vjp(lambda *v: j_gnconvres3x3(*v, 8, True),
                             *args, jnp.asarray(r))
    else:
        out_j, vjp = jax.vjp(lambda *v: j_gnconv3x3(*v, 8, True), *args)
    grads_j = vjp(jnp.asarray(g))

    xt, at, st, bt = (t(v).requires_grad_() for v in (x, a, s, bias))
    w_oihw = t(k).permute(3, 2, 0, 1).contiguous().requires_grad_()
    rt = t(r).requires_grad_() if residual else None
    before = _launches()
    out = conv.GnConv3x3Fn.apply(xt, conv.pack_weight(w_oihw, torch.float32),
                                 bt, at, st, rt)
    (out * t(g)).sum().backward()
    assert _launches() == before
    assert_close(out_j, out, msg="out")
    for name, ref, got in zip(
            ("dx", "da", "ds", "dw", "dbias"), grads_j,
            (xt.grad, at.grad, st.grad, w_oihw.grad.permute(2, 3, 1, 0),
             bt.grad)):
        assert_close(ref, got, msg=name)
    if residual:
        np.testing.assert_array_equal(rt.grad.numpy(), g)


def test_gnconv3x3_fn_skips_gradients_not_needed():
    x, k = rand(20, (1, 8, 8, 4)), rand(21, (3, 3, 4, 8), 0.1)
    a, s = _affine(22, 1, 4)
    xt = t(x).requires_grad_()
    at, st = t(a), t(s)
    w9 = _w9(k)
    out = conv.GnConv3x3Fn.apply(xt, w9, torch.zeros(8), at, st, None)
    out.sum().backward()
    assert xt.grad is not None and xt.grad.abs().sum() > 0
    assert at.grad is None and st.grad is None and w9.grad is None


@pytest.mark.parametrize("pad", PADS)
@pytest.mark.parametrize("shape", [(2, 16, 16, 24, 16), (1, 13, 10, 8, 12)])
def test_downconv3x3_matches_halo_downconv(shape, pad):
    b, h, w, cin, cout = shape
    x, k = rand(30, (b, h, w, cin)), rand(31, (3, 3, cin, cout), 0.1)
    bias = rand(32, (cout,))
    ho = (h + sum(pad[0]) - 3) // 2 + 1
    # one slab of all Ho rows (the Pallas kernel needs block_h | Ho)
    ref = halo_downconv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                        padding=pad, block_h=ho, interpret=True)
    before = _launches()
    out = downconv.downconv3x3(t(x), _w9(k), t(bias),
                               pad[0] + pad[1])
    assert _launches() == before
    assert out.shape[1:3] == downconv.out_size(h, w, pad[0] + pad[1])
    assert_close(ref, out)


@pytest.mark.parametrize("pad", PADS)
def test_downconv3x3_fn_matches_jax_vjp(pad):
    b, h, w, cin, cout = 2, 16, 16, 8, 12
    x, k = rand(40, (b, h, w, cin)), rand(41, (3, 3, cin, cout), 0.1)
    bias = rand(42, (cout,))
    out_j, vjp = jax.vjp(lambda xx, kk, bb: j_downconv3x3(
        xx, kk, bb, pad, 8, True), *map(jnp.asarray, (x, k, bias)))
    g = rand(43, out_j.shape)
    dx_j, dk_j, db_j = vjp(jnp.asarray(g))
    xt, bt = t(x).requires_grad_(), t(bias).requires_grad_()
    w_oihw = t(k).permute(3, 2, 0, 1).contiguous().requires_grad_()
    before = _launches()
    out = downconv.DownConv3x3Fn.apply(
        xt, conv.pack_weight(w_oihw, torch.float32), bt, pad[0] + pad[1])
    (out * t(g)).sum().backward()
    assert _launches() == before
    assert_close(out_j, out, msg="out")
    assert_close(dx_j, xt.grad, msg="dx")
    assert_close(dk_j, w_oihw.grad.permute(2, 3, 1, 0), msg="dw")
    assert_close(db_j, bt.grad, msg="dbias")


def test_group_norm_fold():
    x = rand(50, (2, 8, 8, 16), 3.0) + 0.5
    jm = JL.GroupNorm(4, 1e-5, fold_affine=True)
    p = jm.init(RNG, jnp.asarray(x))
    p = jax.tree_util.tree_map(
        lambda v: v + jnp.asarray(rand(51, v.shape, 0.3)), p)
    a_j, s_j = jm.apply(p, jnp.asarray(x))
    tm = load(TL.GroupNorm(4, 16, 1e-5, act="silu"), p)
    xt = t(x).requires_grad_()
    a, s = tm.fold(xt)
    assert a.dtype == s.dtype == torch.float32
    assert_close(a_j, a, msg="a")
    assert_close(s_j, s, msg="s")
    # x * a + s, then the act, is the unfolded norm
    assert_close(tm(t(x)).detach(), torch.nn.functional.silu(
        t(x) * a[:, None, None] + s[:, None, None]), msg="unfolded")
    (a.sum() + s.square().sum()).backward()  # differentiable in x
    assert xt.grad is not None and torch.isfinite(xt.grad).all()


@pytest.mark.parametrize("cin,cout,temb", [(16, 16, True), (16, 32, True),
                                           (8, 8, False)])
def test_resnet_block_fused(cin, cout, temb):
    x = rand(60, (2, 8, 8, cin))
    tv = rand(61, (2, 64)) if temb else None
    jm = JL.ResnetBlock2D(cout, groups=4)
    jt = None if tv is None else jnp.asarray(tv)
    p = jm.init(RNG, jnp.asarray(x), jt)
    tm = load(TL.ResnetBlock2D(cin, cout, 4, 1e-5, 64 if temb else None,
                               fused_prologue=True), p)
    before = _launches()
    out = tm(t(x), None if tv is None else t(tv))
    assert _launches() == before
    assert_close(jm.apply(p, jnp.asarray(x), jt), out)


def test_downsamplers_strided():
    """The UNet's Downsample2D (pad 1) and the VAE encoder's (pad (0, 1)
    bottom/right, in its DownEncoderBlock2D)."""
    x = rand(70, (2, 8, 8, 16))
    jd = JL.Downsample2D(16)
    pd = jd.init(RNG, jnp.asarray(x))
    td = load(TL.Downsample2D(16, strided=True), pd)
    assert td.conv.strided
    assert_close(jd.apply(pd, jnp.asarray(x)), td(t(x)), msg="unet")
    jb = JV.DownEncoderBlock2D(16, num_layers=1, groups=4)
    pb = jb.init(RNG, jnp.asarray(x))
    tb = load(TV.DownEncoderBlock2D(16, 16, 1, 4, True, FUSED), pb,
              key_rewrites=VAE_REWRITES)
    assert tb.downsamplers[0].conv.pad == (0, 1, 0, 1)
    assert_close(jb.apply(pb, jnp.asarray(x)), tb(t(x)), msg="vae")


def test_fused_configuration_keeps_parameters():
    """Both configurations have the same parameter names and shapes, so one
    state dict serves both."""
    from storygen_tpu_torch.configs import UNetConfig, VAEConfig
    from storygen_tpu_torch.models.unet import UNet2DConditionModel
    ucfg = UNetConfig(block_out_channels=(16, 32, 32, 32),
                      attention_head_dim=4, norm_num_groups=4,
                      cross_attention_dim=24)
    vcfg = VAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                     norm_num_groups=2)
    for cls, cfg in ((UNet2DConditionModel, ucfg), (TV.AutoencoderKL, vcfg)):
        plain, fused = cls(cfg).state_dict(), cls(cfg, FUSED).state_dict()
        assert {k: v.shape for k, v in plain.items()} == \
            {k: v.shape for k, v in fused.items()}
    unet = UNet2DConditionModel(ucfg, FUSED)
    assert all(r.fused_prologue for blk in unet.down_blocks
               for r in blk.resnets)
    assert all(blk.downsamplers[0].conv.strided
               for blk in unet.down_blocks[:-1])


def test_strided_conv_packs_differentiably_or_caches():
    m = TL.StridedConv(4, 6, strided=True)
    torch.nn.init.normal_(m.weight)
    x = t(rand(80, (1, 8, 8, 4)))
    m(x).sum().backward()  # the weight requires grad: packed in the graph
    assert m.weight.grad is not None and m.weight.grad.abs().sum() > 0
    with torch.no_grad():
        assert m.packed_weight(torch.float32) is \
            m.packed_weight(torch.float32)


def test_wrappers_reject_bad_input():
    x = torch.zeros(2, 8, 8, 4)
    w9, bias = torch.zeros(9, 4, 6), torch.zeros(6)
    with pytest.raises(ValueError):  # a and s must be (B, Cin)
        conv.gnconv3x3(x, w9, bias, torch.zeros(4), torch.zeros(4))
    with pytest.raises(ValueError):  # per-batch bias of the wrong batch
        conv.gnconv3x3(x, w9, torch.zeros(3, 6), torch.zeros(2, 4),
                       torch.zeros(2, 4))
    with pytest.raises(ValueError):  # the stride-2 conv takes a (Cout) bias
        downconv.downconv3x3(x, w9, torch.zeros(2, 6), (1, 1, 1, 1))
    with pytest.raises(ValueError):  # four paddings
        downconv.downconv3x3(x, w9, bias, (1, 1))
    with pytest.raises(ValueError):  # no output
        downconv.downconv3x3(torch.zeros(1, 1, 1, 4), w9, bias, (0, 0, 0, 0))
