"""Port parity: each kernel's wrapper (on CPU tensors, i.e. its plain
PyTorch version) against the JAX Pallas kernel it replaces, run in
interpret mode as tests/test_pallas_*.py run them, fp32, tolerance 1e-4.
The kernels themselves run only on the card (chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storygen_tpu.ops.pallas_attention import flash_attention as j_flash
from storygen_tpu.ops.pallas_conv import halo_conv
from storygen_tpu.ops.pallas_geglu import geglu_matmul as j_geglu
from storygen_tpu_torch.ops import conv, flash_attention as fa, geglu
from tests.torch_port_util import assert_close, rand, t


@pytest.mark.parametrize("variant", ["bnd_guard", "online_t"])
@pytest.mark.parametrize("sq,skv,d", [(256, 256, 40), (256, 768, 40),
                                      (256, 512, 80)])
def test_flash_attention(sq, skv, d, variant):
    b, h = 2, 2
    q, k, v = (rand(s, (b, h, n, d)) for s, n in ((0, sq), (1, skv),
                                                   (2, skv)))
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  scale=d ** -0.5, block_q=128, block_k=128, interpret=True,
                  variant=variant)

    def seq(x):  # (B, H, S, D) -> the port's (B, S, H*D)
        return t(x).transpose(1, 2).reshape(b, x.shape[2], h * d)

    before = fa.flash_fwd.launches
    out = fa.flash_attention(seq(q), seq(k), seq(v), h, d ** -0.5)
    assert fa.flash_fwd.launches == before  # CPU: plain version
    assert_close(ref, out.reshape(b, sq, h, d).transpose(1, 2))


@pytest.mark.parametrize("m,n,e", [(256, 512, 320), (256, 1280, 320)])
def test_geglu_matmul(m, n, e):
    proj, w, bias = rand(3, (m, 2 * n)), rand(4, (n, e), 0.02), rand(5, (e,))
    ref = j_geglu(jnp.asarray(proj), jnp.asarray(w), jnp.asarray(bias),
                  interpret=True)
    before = geglu.geglu_matmul.launches
    out = geglu.geglu_matmul(t(proj), t(w).t().contiguous(), t(bias))
    assert geglu.geglu_matmul.launches == before
    assert_close(ref, out)


@pytest.mark.parametrize("per_batch_bias,residual", [(True, False),
                                                     (False, True),
                                                     (True, True)])
def test_conv3x3(per_batch_bias, residual):
    b, h, w, cin, cout = 2, 16, 16, 8, 16
    x, k = rand(6, (b, h, w, cin)), rand(7, (3, 3, cin, cout), 0.1)
    bias = rand(8, (b, cout) if per_batch_bias else (cout,))
    r = rand(9, (b, h, w, cout)) if residual else None
    ref = halo_conv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                    block_h=8, interpret=True,
                    residual=None if r is None else jnp.asarray(r))
    w_oihw = t(k).permute(3, 2, 0, 1)
    w9 = conv.pack_weight(w_oihw, torch.float32)
    np.testing.assert_array_equal(w9.numpy(), k.reshape(9, cin, cout))
    before = conv.conv3x3.launches
    out = conv.conv3x3(t(x), w9, t(bias), None if r is None else t(r))
    assert conv.conv3x3.launches == before
    assert_close(ref, out)


def test_wrappers_reject_bad_input():
    q = torch.zeros(1, 4, 16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 4, 8), torch.zeros(1, 4, 8),
                           2, 1.0)
    with pytest.raises(ValueError):
        geglu.geglu_matmul(torch.zeros(4, 10), torch.zeros(3, 4),
                           torch.zeros(3))
    with pytest.raises(ValueError):
        conv.conv3x3(torch.zeros(1, 4, 4, 3), torch.zeros(9, 3, 5),
                     torch.zeros(2, 5))
