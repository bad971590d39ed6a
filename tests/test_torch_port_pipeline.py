"""Port parity for the slice as a whole: StoryGenSampler.sample for 2 DDIM
steps of the auto-regressive stage with 2 refs (batched reference cycle,
CFG-row dedup, per-ref noise decay, 3-way CFG, DDIM update), then decode,
JAX vs storygen_tpu_torch on the same injected draws and weights (5e-4,
the test_torch_golden.py full-sampler standard); and a per-frame
generate_story of the port on the CPU."""
import jax.numpy as jnp
import numpy as np
import torch

from storygen_tpu.configs import CLIPTextConfig, UNetConfig, VAEConfig
from storygen_tpu.pipeline import StoryGenSampler as JSampler
from storygen_tpu_torch.models.clip_text import CLIPTextModel as TCLIP
from storygen_tpu_torch.models.init import init_random_
from storygen_tpu_torch.models.unet import UNet2DConditionModel as TUNet
from storygen_tpu_torch.models.vae import AutoencoderKL as TVAE
from storygen_tpu_torch.pipeline import StoryGenPipeline
from storygen_tpu_torch.pipeline import StoryGenSampler as TSampler
from tests.torch_port_util import (TINY_CLIP, TINY_UNET, TINY_VAE,
                                   assert_close, rand, serving_models, t,
                                   tokenizer)

UNET_CFG = UNetConfig(**TINY_UNET)
VAE_CFG = VAEConfig(**TINY_VAE)
HW, TXT = 16, 7


def test_sampler_and_decode_match_jax():
    n, b, steps, g_txt, g_img = 2, 1, 2, 7.5, 3.5
    models = serving_models()
    (tunet, junet, up), (tvae, jvae, vp) = models["unet"], models["vae"]
    lat0 = rand(30, (b, HW, HW, 4))
    refs = rand(31, (n, b, HW, HW, 4), 0.5)
    zero = rand(33, (b, HW, HW, 4), 0.05)
    noise = rand(34, (b, HW, HW, 4))
    tu, tc = rand(35, (b, TXT, 24)), rand(36, (b, TXT, 24))
    prev_u = np.stack([rand(37, (b, TXT, 24))] * n)
    prev_c = rand(40, (n, b, TXT, 24))

    js = JSampler(junet, jvae)
    out_j = js.sample({"unet": up, "vae": None}, *map(jnp.asarray, (
        lat0, tu, tc, refs, zero, prev_u, prev_c, noise)),
        jnp.asarray(g_txt), jnp.asarray(g_img), stage="auto-regressive",
        num_inference_steps=steps)
    img_j = js.decode(vp, out_j)

    ts = TSampler(tunet, tvae, device="cpu")
    out_t = ts.sample(*map(t, (lat0, tu, tc, refs, zero, prev_u, prev_c,
                               noise)), g_txt, g_img,
                      stage="auto-regressive", num_inference_steps=steps)
    assert_close(out_j, out_t, atol=5e-4, rtol=5e-4, msg="latents")
    assert_close(img_j, ts.decode(out_t), atol=5e-4, rtol=5e-4, msg="image")


def test_generate_story_runs_on_cpu():
    unet = init_random_(TUNet(UNET_CFG), 1)
    vae = init_random_(TVAE(VAE_CFG), 2)
    clip = init_random_(TCLIP(CLIPTextConfig(**TINY_CLIP)), 3)
    pipe = StoryGenPipeline(unet, vae, clip, tokenizer, device="cpu")
    frames = pipe.generate_story(["a fox", "the fox runs", "it sleeps"],
                                 num_inference_steps=2, height=64, width=64,
                                 seed=7)
    assert len(frames) == 3
    for f in frames:
        assert f.shape == (64, 64, 3) and np.isfinite(f).all()
        assert f.min() >= 0.0 and f.max() <= 1.0
    assert not np.array_equal(frames[0], frames[1])
    again = pipe.generate_story(["a fox"], num_inference_steps=2,
                                height=64, width=64, seed=7)
    np.testing.assert_array_equal(again[0], frames[0])
    # a given opening frame conditions the first generated frame
    kw = dict(num_inference_steps=2, height=64, width=64, seed=7)
    cond = pipe.generate_story(["the fox runs"], first_frame=frames[0],
                               first_caption="a fox", **kw)
    plain = pipe.generate_story(["the fox runs"], **kw)
    assert cond[0].shape == (64, 64, 3) and np.isfinite(cond[0]).all()
    assert not np.array_equal(cond[0], plain[0])
    assert torch.is_grad_enabled()
