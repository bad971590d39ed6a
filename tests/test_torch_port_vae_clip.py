"""Port parity: VAE encode (posterior mean/logvar) and decode, in both conv
configurations (configs.ConvKernels: the default and the fused one, against
one JAX result), and the CLIP text encoder, JAX vs storygen_tpu_torch,
fp32, atol/rtol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from storygen_tpu.configs import CLIPTextConfig, VAEConfig
from storygen_tpu.models.clip_text import init_clip_params
from storygen_tpu.models.vae import AutoencoderKL as JVAE
from storygen_tpu_torch.checkpoint.convert import CLIP_REWRITES, VAE_REWRITES
from storygen_tpu_torch.configs import ConvKernels
from storygen_tpu_torch.models.clip_text import CLIPTextModel as TCLIP
from storygen_tpu_torch.models.vae import AutoencoderKL as TVAE
from tests.torch_port_util import assert_close, load, rand, t


def test_vae_encode_decode():
    cfg = VAEConfig(block_out_channels=(8, 12, 16, 16), layers_per_block=1,
                    norm_num_groups=2)
    jm = JVAE(config=cfg)
    rng = jax.random.PRNGKey(7)
    p = jax.jit(jm.init)(rng, jnp.zeros((1, 32, 32, 3)), rng)
    x = rand(11, (2, 32, 32, 3), 0.7)
    dist = jm.apply(p, jnp.asarray(x), method=JVAE.encode)
    z = rand(12, (2, 4, 4, cfg.latent_channels), 0.9)
    img = jm.apply(p, jnp.asarray(z), method=JVAE.decode)
    for name, conv in (("default", ConvKernels()),
                       ("fused", ConvKernels(True, True))):
        tm = load(TVAE(cfg, conv), p, key_rewrites=VAE_REWRITES)
        with torch.no_grad():
            tdist = tm.encode(t(x))
            assert_close(dist.mean, tdist.mean, msg=f"{name} mean")
            assert_close(dist.logvar, tdist.logvar, msg=f"{name} logvar")
            assert_close(img, tm.decode(t(z)), msg=f"{name} decode")


def test_clip_text_encoder():
    cfg = CLIPTextConfig(num_hidden_layers=2, hidden_size=64,
                         intermediate_size=128, num_attention_heads=4)
    jm, p = init_clip_params(jax.random.PRNGKey(3), cfg)
    tm = load(TCLIP(cfg), p, prefix="text_model.", key_rewrites=CLIP_REWRITES)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 77))
    with torch.no_grad():
        out = tm(torch.from_numpy(ids))
    assert_close(jm.apply(p, jnp.asarray(ids)), out)
