"""Port parity: the full UNet in both cycles (collect: eps + the 16 taps;
consume: eps with a 2-ref kv-concat context), JAX vs storygen_tpu_torch,
fp32, atol/rtol 1e-4, at tiny widths and 16x16 latents. The port's UNet is
held against the JAX one in both conv configurations (the default and the
fused one, configs.ConvKernels); on the CPU the JAX UNet computes the same
function in either, so one JAX result serves both."""
import jax
import jax.numpy as jnp
import pytest
import torch

from storygen_tpu.configs import UNetConfig
from storygen_tpu.models.unet import UNet2DConditionModel as JUNet
from storygen_tpu_torch.configs import ConvKernels
from storygen_tpu_torch.models.unet import CONTEXT_KEYS
from storygen_tpu_torch.models.unet import UNet2DConditionModel as TUNet
from tests.torch_port_util import assert_close, load, rand, t

CFG = UNetConfig(block_out_channels=(16, 32, 32, 32), attention_head_dim=4,
                 norm_num_groups=4, cross_attention_dim=24)
HW, TXT = 16, 7


@pytest.fixture(scope="module")
def unets():
    jm = JUNet(config=CFG)
    p = jax.jit(jm.init)(jax.random.PRNGKey(42), jnp.zeros((1, HW, HW, 4)),
                         jnp.asarray([0]), jnp.zeros((1, TXT, 24)))
    # the port's UNet in the default and in the fused-conv configuration
    return jm, p, {name: load(TUNet(CFG, conv), p) for name, conv in (
        ("default", ConvKernels()), ("fused", ConvKernels(True, True)))}


def test_reference_cycle(unets):
    jm, p, tms = unets
    x, text = rand(0, (2, HW, HW, 4)), rand(1, (2, TXT, 24))
    eps_j, ctx_j = jm.apply(p, jnp.asarray(x), jnp.asarray([981, 45]),
                            jnp.asarray(text))
    for name, tm in tms.items():
        with torch.no_grad():
            eps_t, ctx_t = tm(t(x), torch.tensor([981, 45]), t(text))
        assert_close(eps_j, eps_t, msg=f"{name} eps")
        assert tuple(sorted(ctx_t)) == tuple(sorted(ctx_j)) \
            == tuple(sorted(CONTEXT_KEYS))
        for k in CONTEXT_KEYS:
            assert_close(ctx_j[k], ctx_t[k], msg=f"{name} {k}")


def test_image_cycle(unets):
    jm, p, tms = unets
    x, text = rand(2, (1, HW, HW, 4)), rand(3, (1, TXT, 24))
    refs = rand(10, (2, HW, HW, 4), 0.5)   # 2 reference frames
    rtext = rand(20, (2, TXT, 24))
    # one batched reference pass; each ref's taps concatenated along kv
    raw_j = jm.apply(p, jnp.asarray(refs), jnp.asarray([45, 45]),
                     jnp.asarray(rtext))[1]
    cj = {k: jnp.concatenate([v[0:1], v[1:2]], axis=1)
          for k, v in raw_j.items()}
    eps_j, out_ctx = jm.apply(p, jnp.asarray(x), jnp.asarray([501]),
                              jnp.asarray(text), cj)
    assert not out_ctx
    for name, tm in tms.items():
        with torch.no_grad():
            raw_t = tm(t(refs), torch.tensor([45, 45]), t(rtext))[1]
            ct = {k: torch.cat([v[0:1], v[1:2]], dim=1)
                  for k, v in raw_t.items()}
            eps_t, out_ctx_t = tm(t(x), torch.tensor(501), t(text), ct)
        assert not out_ctx_t
        assert_close(eps_j, eps_t, msg=name)
