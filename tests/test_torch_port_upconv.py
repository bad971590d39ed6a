"""Port parity of the 2x upsample's phase form (ops/upconv.py, kernel U's
module) on the CPU, where the wrapper runs its plain version:
- the phase weights against an independent sum of taps, exactly in fp32;
- the plain phase form against the 3x3 conv of the nearest-upsampled
  input (fp32, 1e-5), at even, odd and one-pixel sources;
- the port's Upsample2D and the VAE's UpDecoderBlock2D against the JAX
  package's on the same parameters (fp32, 1e-4);
- UpConv3x3Fn's gradients against torch autograd through F.interpolate +
  F.conv2d (fp32, 1e-5) and against jax.grad of the JAX Upsample2D (1e-4);
- the backward's phase form: the input gradient's plain version (kernel
  UB's) and the weight gradient's against jax.vjp of the JAX package's
  _UpsampleConv (fp32, 1e-4, odd sizes and one column included), the
  input gradient as the 4x4 stride-2 correlation with the transposed
  phase weights and against autograd in float64, the weight gradient
  against the 3x3 one on the upsampled input, and the backward's routing
  through `upconv3x3_dx`;
- the split plan without the batch, and the kernel's tap addressing;
- the transposed convolution that chip_smoke.py times as U's library
  call computes U's function.
The kernel itself runs only on the card (chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from storygen_tpu.models import layers as JL
from storygen_tpu.models import vae as JV
from storygen_tpu_torch import ops
from storygen_tpu_torch.checkpoint.convert import VAE_REWRITES
from storygen_tpu_torch.configs import ConvKernels
from storygen_tpu_torch.models import layers as TL
from storygen_tpu_torch.models import vae as TV
from storygen_tpu_torch.ops import conv, upconv
from tests.torch_port_util import assert_close, load, rand, t

RNG = jax.random.PRNGKey(0)
# the plain versions against each other, both fp32: a tap summed before or
# after its products moves a sum of ~200 terms of order 1 by ~1e-6
PLAIN_TOL = 1e-5

# the 3x3 taps that phase p's 2-tap row (or column) r sums:
# storygen_tpu/models/layers.py:228-229
TAPS = {(0, 0): (0,), (0, 1): (1, 2), (1, 0): (0, 1), (1, 1): (2,)}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _weights(seed, cin, cout):
    w = t(rand(seed, (cout, cin, 3, 3), (9 * cin) ** -0.5))
    return w, t(rand(seed + 1, (cout,)))


def test_phase_weight_is_the_sum_of_the_taps_that_land_together():
    w = rand(0, (24, 16, 3, 3))
    got = upconv.phase_weight(torch.from_numpy(w), torch.float32).numpy()
    assert got.shape == (16, 16, 24)
    for pa in (0, 1):
        for pb in (0, 1):
            for r in (0, 1):
                for c in (0, 1):
                    # rows first, then columns, as the JAX module sums
                    rows = sum(w[:, :, i, :] for i in TAPS[pa, r])
                    want = sum(rows[:, :, j] for j in TAPS[pb, c])
                    np.testing.assert_array_equal(
                        got[4 * (2 * pa + pb) + 2 * r + c], want.T)
    # the sums are formed in fp32 and cast once
    bf = upconv.phase_weight(torch.from_numpy(w), torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and bf.is_contiguous()
    assert torch.equal(bf, torch.from_numpy(got).to(torch.bfloat16))


@pytest.mark.parametrize("c", [8, 16, 24])
@pytest.mark.parametrize("h, w", [(1, 1), (2, 7), (5, 6), (8, 8)])
@pytest.mark.parametrize("b", [1, 2])
def test_plain_phases_equal_the_conv_of_the_upsampled_input(b, h, w, c):
    cout = c + 8  # Cin != Cout, so that a swapped axis shows
    x = t(rand(1, (b, h, w, c)))
    weight, bias = _weights(2, c, cout)
    got = upconv.upconv3x3_plain(x, upconv.phase_weight(weight,
                                                        torch.float32), bias)
    ref = conv.conv3x3_plain(upconv.upsample_nearest(x),
                             conv.pack_weight(weight, torch.float32), bias)
    assert got.shape == (b, 2 * h, 2 * w, cout)
    torch.testing.assert_close(got, ref, atol=PLAIN_TOL, rtol=PLAIN_TOL)


@pytest.mark.parametrize("shape", [(2, 4, 6, 8), (2, 5, 3, 8)])
def test_upsample2d_matches_jax(shape):
    x = rand(3, shape)
    jm = JL.Upsample2D(8)
    p = jm.init(RNG, jnp.asarray(x))
    tm = load(TL.Upsample2D(8), p)
    with torch.no_grad():
        assert_close(jm.apply(p, jnp.asarray(x)), tm(t(x)))


@pytest.mark.parametrize("conv_kernels", [ConvKernels(),
                                          ConvKernels(True, True)],
                         ids=["default", "fused"])
@pytest.mark.parametrize("shape", [(2, 4, 4, 8), (1, 5, 3, 8)])
def test_vae_up_decoder_block_matches_jax(shape, conv_kernels):
    x = rand(4, shape)
    jm = JV.UpDecoderBlock2D(16, num_layers=1, groups=4)
    p = jm.init(RNG, jnp.asarray(x))
    tm = load(TV.UpDecoderBlock2D(8, 16, 1, 4, True, conv_kernels), p,
              key_rewrites=VAE_REWRITES)
    with torch.no_grad():
        assert_close(jm.apply(p, jnp.asarray(x)), tm(t(x)))


def _port_grads(x, weight, bias, g, plain: bool):
    """x, weight and bias gradients of sum(Upsample2D(x) * g) through the
    port's module: UpConv3x3Fn, or its plain side under plain_path()."""
    m = TL.Upsample2D(x.shape[-1])
    with torch.no_grad():
        m.conv.weight.copy_(weight)
        m.conv.bias.copy_(bias)
    xt = x.clone().requires_grad_(True)
    if plain:
        with ops.plain_path():
            out = m(xt)
    else:
        out = m(xt)
    (out * g).sum().backward()
    return out, xt.grad, m.conv.weight.grad, m.conv.bias.grad


@pytest.mark.parametrize("plain", [False, True], ids=["kernel", "plain"])
@pytest.mark.parametrize("shape", [(2, 4, 6, 8), (1, 3, 5, 16)])
def test_upconv_gradients_match_interpolate_and_conv2d(shape, plain):
    b, h, w, c = shape
    x = t(rand(5, shape))
    weight, bias = _weights(6, c, c)
    g = t(rand(7, (b, 2 * h, 2 * w, c)))
    out, dx, dw, db = _port_grads(x, weight, bias, g, plain)
    xr = x.permute(0, 3, 1, 2).clone().requires_grad_(True)
    wr, br = weight.clone().requires_grad_(True), bias.clone().requires_grad_(
        True)
    ref = F.conv2d(F.interpolate(xr, scale_factor=2, mode="nearest"), wr, br,
                   padding=1)
    (ref * g.permute(0, 3, 1, 2)).sum().backward()
    torch.testing.assert_close(out.detach(), ref.detach().permute(0, 2, 3, 1),
                               atol=PLAIN_TOL, rtol=PLAIN_TOL)
    for got, want in ((dx, xr.grad.permute(0, 2, 3, 1)), (dw, wr.grad),
                      (db, br.grad)):
        torch.testing.assert_close(got, want, atol=PLAIN_TOL * float(
            want.abs().max()), rtol=PLAIN_TOL)


def test_upconv_gradients_match_jax_grad():
    x = rand(8, (2, 5, 4, 8))
    g = rand(9, (2, 10, 8, 8))
    jm = JL.Upsample2D(8)
    p = jm.init(RNG, jnp.asarray(x))

    def loss(params, xx):
        return jnp.sum(jm.apply(params, xx) * jnp.asarray(g))

    jp, jx = jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(x))
    kernel = np.asarray(p["params"]["conv"]["kernel"])  # (3, 3, Cin, Cout)
    weight = t(kernel).permute(3, 2, 0, 1)
    bias = t(p["params"]["conv"]["bias"])
    _, dx, dw, db = _port_grads(t(x), weight, bias, t(g), plain=False)
    assert_close(jx, dx)
    assert_close(jp["params"]["conv"]["kernel"], dw.permute(2, 3, 1, 0))
    assert_close(jp["params"]["conv"]["bias"], db)


def test_backward_skips_the_gradients_not_needed(monkeypatch):
    """With a frozen weight (stage-2 training's upsamplers) only dx is
    formed, by `upconv3x3_dx`: neither the weight gradient's tap products
    nor an upsampled input exist; with a frozen input, no dx."""
    x = t(rand(10, (1, 3, 3, 8))).requires_grad_(True)
    weight, bias = _weights(11, 8, 8)
    w9 = conv.pack_weight(weight, torch.float32)
    w16 = upconv.phase_weight(weight, torch.float32)
    calls = []
    for name in ("upsample_nearest", "upconv3x3_dweight_plain",
                 "upconv3x3_dx"):
        real = getattr(upconv, name)
        monkeypatch.setattr(upconv, name, lambda *a, real=real, name=name:
                            calls.append(name) or real(*a))
    out = upconv.UpConv3x3Fn.apply(x, w9, bias, w16)
    out.sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape
    assert calls == ["upconv3x3_dx"]
    calls.clear()
    w9 = w9.clone().requires_grad_(True)
    out = upconv.UpConv3x3Fn.apply(x.detach(), w9, bias, w16)
    out.sum().backward()
    assert w9.grad is not None and calls == ["upconv3x3_dweight_plain"]


# (Cin, Cout, source side, splits) of U at the UNet's three up blocks and
# the VAE decoder's three: only the 8x8 source at 1280 channels (10 Cout
# blocks, 40 with its phases) leaves the card short of blocks
UP_SITES = [(1280, 1280, 8, 4), (1280, 1280, 16, 1), (640, 640, 32, 1),
            (512, 512, 64, 1), (512, 512, 128, 1), (256, 256, 256, 1)]


@pytest.mark.parametrize("cin, cout, side, splits", UP_SITES)
def test_split_plan_ignores_the_batch(cin, cout, side, splits):
    line = upconv.up_tile(cin, cout, side)
    assert line == upconv.UP_BUILT[conv.tile_key(1, False, cin, cout, side)]
    assert upconv.up_splits(cin, cout, side, side) == splits
    for b in (1, 2, 3, 4, 6, 12):
        shape = upconv.workspace_shape(b, side, side, cin, cout)
        assert (1 if shape is None else shape[0]) == splits
        assert shape is None or shape == (splits, b * 4 * side * side, cout)
    assert upconv.up_tile(cin, cout, side) == line


@pytest.mark.parametrize("h, w", [(1, 1), (3, 5), (8, 8)])
def test_phase_taps_read_the_halo_slab(h, w):
    """The kernel's addressing (csrc/conv_wgmma.cuh's tap_row): phase (pa,
    pb)'s tap (r, c) of source pixel (y, x) reads the slab, which starts
    one pixel above and left of its tile and reads 0 outside the image, at
    offset (pa + r, pb + c); gathered so, the sum equals the plain
    version."""
    b, cin, cout = 2, 8, 16
    x = t(rand(12, (b, h, w, cin)))
    weight, bias = _weights(13, cin, cout)
    w16 = upconv.phase_weight(weight, torch.float32)
    slab = F.pad(x, (0, 0, 1, 1, 1, 1))  # source row y at slab row y + 1
    out = torch.zeros(b, 2 * h, 2 * w, cout) + bias
    for pa in (0, 1):
        for pb in (0, 1):
            for tap in range(4):
                r, c = divmod(tap, 2)
                piece = slab[:, pa + r:pa + r + h, pb + c:pb + c + w]
                out[:, pa::2, pb::2] += piece @ w16[4 * (2 * pa + pb) + tap]
    torch.testing.assert_close(out, upconv.upconv3x3_plain(x, w16, bias),
                               atol=PLAIN_TOL, rtol=PLAIN_TOL)


def test_library_yardstick_computes_the_same_function():
    """chip_smoke.py times F.conv_transpose2d on chip_smoke.transposed_
    weight(w16) as U's library call: the one PyTorch call of U's
    function."""
    import chip_smoke
    x = t(rand(14, (2, 5, 6, 16)))
    weight, bias = _weights(15, 16, 24)
    w16 = upconv.phase_weight(weight, torch.float32)
    got = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                             chip_smoke.transposed_weight(w16), bias,
                             stride=2, padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, upconv.upconv3x3_plain(x, w16, bias),
                               atol=PLAIN_TOL, rtol=PLAIN_TOL)


def test_cpu_wrapper_is_the_plain_version_and_checks_operands():
    x = t(rand(16, (1, 2, 3, 8)))
    weight, bias = _weights(17, 8, 16)
    w16 = upconv.phase_weight(weight, torch.float32)
    before = upconv.upconv3x3.launches
    assert torch.equal(upconv.upconv3x3(x, w16, bias),
                       upconv.upconv3x3_plain(x, w16, bias))
    assert upconv.upconv3x3.launches == before  # the CPU runs no kernel
    with pytest.raises(ValueError):
        upconv.upconv3x3(x, w16[:9], bias)
    with pytest.raises(ValueError):
        upconv.upconv3x3(x, w16, bias[:8])


def _phase64(weight):
    """phase_weight's tap sums in float64 (phase_weight sums in fp32)."""
    k = weight.permute(2, 3, 1, 0)
    cin, cout = k.shape[2:]
    return torch.stack([upconv._pair(upconv._pair(k, 0, a), 1, b)
                        for a in (0, 1) for b in (0, 1)]).reshape(
        16, cin, cout)


# (B, source H, W, Cin, Cout) of the backward's checks: even, odd and
# one-column sources, Cin != Cout
DX_SHAPES = [(2, 4, 6, 8, 16), (1, 5, 3, 8, 8), (2, 3, 1, 16, 8),
             (1, 1, 1, 8, 8)]


@pytest.mark.parametrize("b, h, w, cin, cout", DX_SHAPES)
def test_backward_plain_versions_match_jax_vjp(b, h, w, cin, cout):
    """U's input gradient (`upconv3x3_dx_plain`, kernel UB's plain version)
    and weight gradient (`upconv3x3_dweight_plain`) against jax.vjp of the
    JAX package's _UpsampleConv, whose gradient XLA forms from the four
    phase convs (fp32, 1e-4)."""
    x = rand(20 + h, (b, h, w, cin))
    g = rand(21 + w, (b, 2 * h, 2 * w, cout))
    jm = JL._UpsampleConv(cout)
    p = jm.init(RNG, jnp.asarray(x))
    _, vjp = jax.vjp(lambda pp, xx: jm.apply(pp, xx), p, jnp.asarray(x))
    jp, jx = vjp(jnp.asarray(g))
    weight = t(p["params"]["kernel"]).permute(3, 2, 0, 1)  # OIHW
    w16 = upconv.phase_weight(weight, torch.float32)
    assert_close(jx, upconv.upconv3x3_dx_plain(t(g), w16))
    dw9 = upconv.upconv3x3_dweight_plain(t(x), t(g))
    assert_close(jp["params"]["kernel"], dw9.reshape(3, 3, cin, cout))


@pytest.mark.parametrize("b, h, w, cin, cout", DX_SHAPES)
def test_dx_is_the_strided_correlation_of_the_transposed_weight(
        b, h, w, cin, cout):
    """In float64, F.conv2d(g, k, stride=2, padding=1) with k
    chip_smoke.transposed_weight(w16) read as a (Cin, Cout, 4, 4) conv
    weight (cuDNN's one call of UB's function, the smoke's library) equals
    autograd's dx of F.conv2d(F.interpolate(x, 2), w, padding=1); so does
    the plain input gradient, and the phase-form weight gradient autograd's
    dw and the 3x3 one on the upsampled input, within their fp32 sums."""
    import chip_smoke
    rs = np.random.RandomState(b * 100 + h * 10 + w)
    x = torch.tensor(rs.randn(b, h, w, cin)).requires_grad_(True)
    weight = torch.tensor(rs.randn(cout, cin, 3, 3)).requires_grad_(True)
    y = F.conv2d(F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                               mode="nearest"), weight, padding=1)
    g = torch.tensor(rs.randn(*y.shape))
    dx, dw = torch.autograd.grad(y, (x, weight), g)
    w16 = _phase64(weight.detach())
    gn = g.permute(0, 2, 3, 1).contiguous()
    corr = F.conv2d(g, chip_smoke.transposed_weight(w16), stride=2,
                    padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(corr, dx, atol=1e-10, rtol=1e-10)
    # the plain versions sum in fp32
    tol = dict(atol=1e-5 * float(dx.abs().max()), rtol=1e-5)
    torch.testing.assert_close(upconv.upconv3x3_dx_plain(gn, w16), dx, **tol)
    dw9 = upconv.upconv3x3_dweight_plain(x.detach(), gn).double()
    want = conv.pack_weight(dw, torch.float64)
    tol = dict(atol=1e-5 * float(want.abs().max()), rtol=1e-5)
    torch.testing.assert_close(dw9, want, **tol)
    torch.testing.assert_close(
        dw9, conv.conv3x3_dweight_plain(
            upconv.upsample_nearest(x.detach()), gn).double(), **tol)


def test_backward_routes_dx_through_the_ub_wrapper(monkeypatch):
    """UpConv3x3Fn's dx is `upconv3x3_dx(g, w16)` (kernel UB on the card,
    its plain version here) on the saved phase weights, cast to x's
    dtype."""
    x = t(rand(22, (2, 3, 5, 8))).requires_grad_(True)
    weight, bias = _weights(23, 8, 16)
    w9 = conv.pack_weight(weight, torch.float32)
    w16 = upconv.phase_weight(weight, torch.float32)
    g = t(rand(24, (2, 6, 10, 16)))
    seen = []
    real = upconv.upconv3x3_dx
    monkeypatch.setattr(upconv, "upconv3x3_dx",
                        lambda gg, ww: seen.append((gg, ww)) or real(gg, ww))
    out = upconv.UpConv3x3Fn.apply(x, w9, bias, w16)
    out.backward(g)
    assert len(seen) == 1 and seen[0][1] is w16
    assert torch.equal(seen[0][0], g)
    assert torch.equal(x.grad, upconv.upconv3x3_dx_plain(g, w16))


def test_cpu_dx_wrapper_is_the_plain_version_and_checks_operands():
    g = t(rand(25, (1, 4, 6, 16)))
    weight, _ = _weights(26, 8, 16)
    w16 = upconv.phase_weight(weight, torch.float32)
    before = upconv.upconv3x3_dx.launches
    got = upconv.upconv3x3_dx(g, w16)
    assert got.shape == (1, 2, 3, 8)
    assert torch.equal(got, upconv.upconv3x3_dx_plain(g, w16))
    assert upconv.upconv3x3_dx.launches == before  # the CPU runs no kernel
    with pytest.raises(ValueError):
        upconv.upconv3x3_dx(g[:, :3], w16)  # odd cotangent height
    with pytest.raises(ValueError):
        upconv.upconv3x3_dx(g, w16[:9])
    with pytest.raises(ValueError):
        upconv.upconv3x3_dx(g[..., :8], w16)  # channels != w16's Cout


def test_phase_weight_adjoint_is_the_transpose_of_the_tap_sums():
    """<phase_weight(w), d> == <w, phase_weight_adjoint(d)> for any w and
    d: the weight gradient's last step is the exact adjoint."""
    rs = np.random.RandomState(27)
    w = torch.tensor(rs.randn(6, 4, 3, 3))
    d = torch.tensor(rs.randn(16, 4, 6))
    lhs = (_phase64(w) * d).sum()
    rhs = (conv.pack_weight(w, torch.float64)
           * upconv.phase_weight_adjoint(d)).sum()
    torch.testing.assert_close(lhs, rhs, atol=1e-12, rtol=1e-12)


def test_dx_weight_packing_and_ub_plan_ignore_the_batch():
    """UB's packing is a function of w16 alone, and its line and split
    plan at the training path's up blocks see no batch."""
    for cin, side in ((1280, 8), (1280, 16), (640, 32)):
        line = upconv.dx_tile(cin, cin, side)
        assert line == upconv.UB_BUILT[conv.tile_key(2, False, cin, cin,
                                                      side)]
        assert upconv.dx_splits(cin, cin, side, side) == conv.split_count(
            line, cin, cin, side, side)
    w16 = t(rand(28, (16, 8, 16)))
    k16 = upconv.dx_weight(w16)
    # tap (ty, tx) of the window: cotangent row 2r - 1 + ty lies in phase
    # (ty + 1) % 2, which reached source row r through its tap 1 - ty // 2
    taps = [4 * (2 * ((ty + 1) % 2) + (tx + 1) % 2) + 2 * (1 - ty // 2)
            + 1 - tx // 2 for ty in range(4) for tx in range(4)]
    assert sorted(taps) == list(range(16))
    for tap, src in enumerate(taps):
        assert torch.equal(k16[tap], w16[src].t())
