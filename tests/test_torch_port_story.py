"""Port parity for the slice as a whole: generate_story(fused=True), the
port's story_rollout, against the JAX package's story_rollout (its one
jitted program per story), fed the JAX package's own draws (fold_in(rng,
k), split in 5), on 3 frames of 2 DDIM steps with max_refs 2: fused
against fused, as the JAX fused program matches its own per-frame path
only to roundoff (5e-4 in [0, 1] pixels, the slice standard). Then the
port's fused story against its own per-frame story on the same draws, at
the JAX package's bound for the same pair (2e-5,
tests/test_pipeline.py), also with euler_a's per-step draws from the
default provider and a given first frame."""
import jax
import numpy as np

from storygen_tpu.pipeline import StoryGenPipeline as JPipeline
from storygen_tpu_torch.pipeline import StoryGenPipeline
from tests.torch_port_util import (jax_story_draws, serving_models,
                                   tokenizer)

PROMPTS = ["a fox", "the fox runs", "it sleeps"]
KW = dict(num_inference_steps=2, height=64, width=64, max_refs=2)


def _close(ref, got, tol, msg):
    assert len(ref) == len(got)
    for k, (r, g) in enumerate(zip(ref, got)):
        assert g.shape == (64, 64, 3) and np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(r), atol=tol, rtol=tol,
                                   err_msg=f"{msg} frame {k}")


def test_fused_story_matches_jax_story_rollout():
    m = serving_models(clip=True)
    (unet, junet, up), (vae, jvae, vp), (clip, jclip, cp) = (
        m["unet"], m["vae"], m["clip"])
    jpipe = JPipeline(junet, up, jvae, vp, jclip, cp, tokenizer)
    pipe = StoryGenPipeline(unet, vae, clip, tokenizer, device="cpu")
    rng = jax.random.PRNGKey(3)
    ref = jpipe.generate_story(PROMPTS, rng=rng, fused=True, **KW)
    fused = pipe.generate_story(PROMPTS, fused=True,
                                draw=jax_story_draws(rng, 3), **KW)
    _close(ref, fused, 5e-4, "port fused vs JAX story_rollout")
    per_frame = pipe.generate_story(PROMPTS, draw=jax_story_draws(rng, 3),
                                    **KW)
    _close(fused, per_frame, 2e-5, "port per-frame vs port fused")
    assert not np.array_equal(fused[0], fused[1])

    # euler_a's step draws come from the default provider in the same
    # order on both paths
    kw = dict(KW, sampler="euler_a", first_frame=fused[2],
              first_caption="it sleeps", seed=11)
    fused = pipe.generate_story(PROMPTS[:2], fused=True, **kw)
    per_frame = pipe.generate_story(PROMPTS[:2], **kw)
    _close(fused, per_frame, 2e-5, "euler_a, first frame")
