"""Port parity: checkpoint conversion and the noise schedule.

storygen_tpu_torch/checkpoint/convert.py must give the same keys and values
as storygen_tpu/checkpoint/hf_export.py::flax_to_torch_state_dict, and the
converted dicts must load strictly into the port's modules; the schedule
tables, timesteps, add_noise and ddim_step must match the JAX ones.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storygen_tpu.checkpoint.hf_export import flax_to_torch_state_dict
from storygen_tpu.checkpoint.hf_import import CLIP_REWRITES, VAE_REWRITES
from storygen_tpu.configs import (CLIPTextConfig, SchedulerConfig,
                                  UNetConfig, VAEConfig)
from storygen_tpu.diffusion import schedule as JS
from storygen_tpu_torch.checkpoint import convert
from storygen_tpu_torch.diffusion import schedule as TS
from tests.torch_port_util import np_tree, rand, t

UNET_CFG = UNetConfig(block_out_channels=(16, 32, 32, 32),
                      attention_head_dim=4, norm_num_groups=4,
                      cross_attention_dim=24)
VAE_CFG = VAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                    norm_num_groups=2)
CLIP_CFG = CLIPTextConfig(num_hidden_layers=2, hidden_size=64,
                          intermediate_size=128, num_attention_heads=4)


def _unet():
    from storygen_tpu.models.unet import UNet2DConditionModel as J
    from storygen_tpu_torch.models.unet import UNet2DConditionModel as T
    p = jax.jit(J(config=UNET_CFG).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)), jnp.asarray([0]),
        jnp.zeros((1, 7, 24)))
    return (p, convert.unet_state_dict, flax_to_torch_state_dict(p),
            T(UNET_CFG))


def _vae():
    from storygen_tpu.models.vae import AutoencoderKL as J
    from storygen_tpu_torch.models.vae import AutoencoderKL as T
    rng = jax.random.PRNGKey(1)
    p = jax.jit(J(config=VAE_CFG).init)(rng, jnp.zeros((1, 32, 32, 3)), rng)
    return (p, convert.vae_state_dict,
            flax_to_torch_state_dict(p, key_rewrites=VAE_REWRITES), T(VAE_CFG))


def _clip():
    from storygen_tpu.models.clip_text import init_clip_params
    from storygen_tpu_torch.models.clip_text import CLIPTextModel as T
    _, p = init_clip_params(jax.random.PRNGKey(2), CLIP_CFG)
    return (p, convert.clip_state_dict,
            flax_to_torch_state_dict(p, prefix="text_model.",
                                     key_rewrites=CLIP_REWRITES),
            T(CLIP_CFG))


@pytest.mark.parametrize("build", [_unet, _vae, _clip],
                         ids=["unet", "vae", "clip"])
def test_convert_matches_hf_export(build):
    params, fn, ref, module = build()
    got = fn(np_tree(params))
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
    # the port's module names and shapes are the diffusers ones
    module.load_state_dict(got, strict=True)


def test_schedule_tables_and_timesteps():
    cfg = SchedulerConfig()
    js, ts = JS.make_schedule(cfg), TS.make_schedule(cfg)
    np.testing.assert_array_equal(ts.alphas_cumprod.numpy(),
                                  np.asarray(js.alphas_cumprod))
    np.testing.assert_array_equal(ts.betas.numpy(), np.asarray(js.betas))
    assert float(ts.final_alpha_cumprod) == float(js.final_alpha_cumprod)
    for n in (1, 2, 10, 50):
        np.testing.assert_array_equal(TS.ddim_timesteps(cfg, n),
                                      JS.ddim_timesteps(cfg, n))


@pytest.mark.parametrize("t_cur,prev_t", [(981, 961), (501, 481), (1, -19)])
def test_add_noise_and_ddim_step(t_cur, prev_t):
    cfg = SchedulerConfig()
    js, ts = JS.make_schedule(cfg), TS.make_schedule(cfg)
    x, eps = rand(0, (2, 8, 8, 4)), rand(1, (2, 8, 8, 4))
    np.testing.assert_allclose(
        TS.ddim_step(ts, t(eps), t_cur, prev_t, t(x)).numpy(),
        np.asarray(JS.ddim_step(js, jnp.asarray(eps), jnp.asarray(t_cur),
                                jnp.asarray(prev_t), jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    steps = np.asarray([t_cur, t_cur // 2])
    np.testing.assert_allclose(
        TS.add_noise(ts, t(x), t(eps), torch.from_numpy(steps)).numpy(),
        np.asarray(JS.add_noise(js, jnp.asarray(x), jnp.asarray(eps),
                                jnp.asarray(steps))),
        rtol=1e-6, atol=1e-6)
