"""Port parity for generate_story's options, JAX package against the port
on the same weights and the JAX package's own draws (5e-4 in [0, 1]
pixels), 2 frames of 2 DDIM steps after a given first frame, max_refs 2:
reuse_latents (each frame's final latents fed back as a reference; the
first frame encoded with the draw of fold_in(rng, len(prompts))) and
normalize_refs (history frames to the VAE in [-1, 1])."""
import jax
import numpy as np
import pytest

from storygen_tpu.pipeline import StoryGenPipeline as JPipeline
from storygen_tpu_torch.pipeline import StoryGenPipeline
from tests.torch_port_util import (jax_story_draws, rand, serving_models,
                                   tokenizer)

PROMPTS = ["the fox runs", "it sleeps"]


@pytest.fixture(scope="module")
def pipes():
    m = serving_models(clip=True)
    (unet, junet, up), (vae, jvae, vp), (clip, jclip, cp) = (
        m["unet"], m["vae"], m["clip"])
    return (JPipeline(junet, up, jvae, vp, jclip, cp, tokenizer),
            StoryGenPipeline(unet, vae, clip, tokenizer, device="cpu"))


@pytest.mark.parametrize("option", ["reuse_latents", "normalize_refs"])
def test_story_option_matches_jax(pipes, option):
    jpipe, pipe = pipes
    first = np.clip(rand(50, (64, 64, 3), 0.3) + 0.5, 0.0, 1.0)
    rng = jax.random.PRNGKey(4)
    kw = {option: True, "first_frame": first, "first_caption": "a fox",
          "num_inference_steps": 2, "height": 64, "width": 64,
          "max_refs": 2}
    ref = jpipe.generate_story(PROMPTS, rng=rng, **kw)
    got = pipe.generate_story(PROMPTS, draw=jax_story_draws(rng, 2), **kw)
    assert len(got) == len(ref) == 2
    for k, (r, g) in enumerate(zip(ref, got)):
        assert g.shape == (64, 64, 3) and np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(r), atol=5e-4, rtol=5e-4,
                                   err_msg=f"{option} frame {k}")
