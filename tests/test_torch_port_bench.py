"""Port parity for the serving timers, storygen_tpu_torch/scripts/bench.py
and bench_story.py, against the JAX package on the same weights and
inputs (5e-4 in [0, 1] pixels, the slice standard), on a two-level tiny
UNet (its JAX sample loop compiles in a few seconds) at 64 px, DDIM-2:

- bench.run's timed frames (3 refs, guidance 7.0 / 3.5, each iteration
  salted by the previous image's mean) against JAX `sample` + `decode` on
  the inputs that `frame_inputs` draws, the warm-up and chain included;
  the chain itself bit for bit on the port;
- bench_story.run's per-frame and --reuse-latents stories against a chain
  of JAX `sample`, `decode` and VAE `encode` calls that follows the JAX
  script, with the posterior draws that the port reuses injected into the
  JAX encode (the JAX script's own PRNGKey(1) draw cannot be matched);
- the --fused story against JAX `story_rollout` on the JAX package's own
  draws (`jax_story_draws`), as tests/test_torch_port_story.py does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storygen_tpu.pipeline import StoryGenSampler as JSampler
from storygen_tpu_torch.models.layers import Conv3x3
from storygen_tpu_torch.pipeline import StoryGenSampler
from storygen_tpu_torch.scripts import bench, bench_story
from tests.torch_port_util import jax_story_draws, serving_models

# two levels, one resnet a level, attention (attn1-3) at the first level
# and the mid block
BENCH_UNET = dict(block_out_channels=(16, 32), attention_head_dim=4,
                  norm_num_groups=4, cross_attention_dim=24,
                  layers_per_block=1,
                  down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                  up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))
PX, STEPS, TOL = 64, 2, 5e-4
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Jax:
    """The JAX package's sampler on the same weights, its VAE's encode
    and decode jitted at batch 1."""

    def __init__(self, models):
        (_, junet, up), (_, jvae, vp) = models["unet"], models["vae"]
        self.sampler = JSampler(junet, jvae)
        self.params, self.vp = {"unet": up, "vae": vp}, vp
        self.sf = jvae.config.scaling_factor
        self._decode = jax.jit(self.sampler.decode)
        self._encode = jax.jit(
            lambda p, x: jvae.apply(p, x, method=jvae.encode))

    def frame(self, lat0, text_u, text_c, refs, zero, prev_u, prev_c,
              noise):
        stage = "no" if refs is None else "auto-regressive"
        lat = self.sampler.sample(
            self.params, lat0, text_u, text_c, refs, zero, prev_u, prev_c,
            noise, jnp.asarray(7.0), jnp.asarray(3.5), stage=stage,
            num_inference_steps=STEPS)
        return self._decode(self.vp, lat), lat

    def encode_refs(self, hist, posterior):
        """(n, 1, H, W, 3) pixels -> (n, 1, h, w, 4) scaled posterior
        draws on `posterior` (n, h, w, 4), one frame at a time."""
        dists = [self._encode(self.vp, img) for img in hist]
        mean = jnp.concatenate([d.mean for d in dists])
        logvar = jnp.concatenate([d.logvar for d in dists])
        z = (mean + jnp.exp(0.5 * logvar) * posterior) * self.sf
        return z[:, None]


@pytest.fixture(scope="module")
def both():
    models = serving_models(unet=BENCH_UNET)
    port = {"unet": models["unet"][0], "vae": models["vae"][0]}
    return port, Jax(models)


def a(x) -> jnp.ndarray:
    return jnp.asarray(x.detach().numpy())


def close(got, ref, msg):
    got = got.detach().numpy()
    assert got.shape == np.shape(ref) and np.isfinite(got).all(), msg
    np.testing.assert_allclose(got, np.asarray(ref), atol=TOL, rtol=TOL,
                               err_msg=msg)


def test_bench_frame_matches_jax(both):
    port, jx = both
    line, images = bench.run(port, steps=STEPS, iters=2, height=PX,
                             device="cpu")
    assert line["metric"] == \
        "frames_per_sec_per_chip_64px_ddim2_autoregressive_3ref"
    assert line["unit"] == "frames/s" and line["value"] > 0
    assert line["device"] == "cpu" and line["conv"] == "default"
    # each iteration's host time; no card timeline on the CPU
    assert line["iter_device_ms"] is None
    assert len(line["iter_host_ms"]) == 2
    assert sum(line["iter_host_ms"]) == pytest.approx(
        2e3 / line["value"], rel=0.05)
    inp = bench.frame_inputs(port["unet"], 1, PX, 2, CPU)
    fixed = [a(inp[k]) for k in ("text_u", "text_c", "refs", "zero",
                                 "prev_u", "prev_c", "noise")]
    salt = jnp.float32(0.0)
    for i in (2, 0, 1):  # the warm-up's draw, then the timed iterations
        img, _ = jx.frame(a(inp["latents"][i]) + salt * 1e-6, *fixed)
        salt = img.mean()
        if i < 2:
            close(images[i], img, f"iteration {i}")
    assert not torch.equal(images[0], images[1])
    # iteration 1 starts from iteration 0's mean: bit for bit
    sampler = StoryGenSampler(port["unet"], port["vae"], device="cpu")
    lat = inp["latents"][1]
    assert torch.equal(bench.frame(sampler, inp, lat, images[0].mean(),
                                   STEPS), images[1])
    assert not torch.equal(bench.frame(sampler, inp, lat, torch.zeros(()),
                                       STEPS), images[1])


@pytest.mark.parametrize("reuse", [False, True])
def test_bench_story_matches_jax_chain(both, reuse):
    port, jx = both
    line, outs = bench_story.run(port, reuse=reuse, steps=STEPS, stories=1,
                                 height=PX, device="cpu")
    assert line["metric"] == ("story_p50_latency_4frame_64px_ddim2"
                              + ("_reuse_latents" if reuse else ""))
    assert line["all_times"] == [line["value"]] and line["device"] == "cpu"
    assert line["frames_per_sec_equiv"] == 4 / line["value"]
    assert line["times"] == line["all_times"]
    assert line["frames_device_ms"] == [None]
    (frames_ms,) = line["frames_host_ms"]
    assert len(frames_ms) == 4
    assert sum(frames_ms) == pytest.approx(1e3 * line["value"], rel=0.05)
    story = bench_story.Story(StoryGenSampler(port["unet"], port["vae"],
                                              device="cpu"), 1, PX, STEPS,
                              CPU)
    text_u, zero, noise = a(story.text_u), a(story.zero), a(story.noise)

    def jax_story(seed, salt):
        lats, texts = story.draws(seed)
        texts = [a(x) for x in texts]
        hist, frames = [], []
        for k in range(4):
            lat0 = a(lats[k]) + salt * 1e-6
            n = min(k, 3)
            if n == 0:
                img, lat = jx.frame(lat0, text_u, texts[k], *[None] * 4,
                                    noise)
            else:
                refs = (jnp.stack(hist[-n:]) if reuse else jx.encode_refs(
                    hist[-n:], a(story.posterior[n])))
                img, lat = jx.frame(lat0, text_u, texts[k], refs, zero,
                                    jnp.stack([text_u] * n),
                                    jnp.stack(texts[:n]), noise)
            salt = img.mean()
            frames.append(img)
            hist.append(lat if reuse else img)
        return jnp.stack(frames), salt

    _, salt = jax_story(bench_story.WARMUP_SEED, jnp.float32(0.0))
    ref, _ = jax_story(0, salt)
    close(outs[0], ref, f"story, reuse={reuse}")
    assert not torch.equal(outs[0][0], outs[0][1])


def test_bench_story_fused_matches_jax_story_rollout(both):
    port, jx = both
    line, outs = bench_story.run(port, fused=True, steps=STEPS, stories=1,
                                 height=PX, device="cpu")
    assert line["metric"] == "story_p50_latency_4frame_64px_ddim2_fused"
    assert outs[0].shape == (4, 1, PX, PX, 3)
    story = bench_story.Story(StoryGenSampler(port["unet"], port["vae"],
                                              device="cpu"), 1, PX, STEPS,
                              CPU)
    rng = jax.random.PRNGKey(5)
    salt = torch.tensor(0.25)
    frames, mean = story.fused(0, salt, draw=jax_story_draws(rng, 4))
    assert mean == frames.mean()
    _, texts = story.draws(0)
    ref = jx.sampler.story_rollout(
        jx.params, a(story.text_u), a(torch.stack(texts)) + 0.25 * 1e-6,
        rng, jnp.asarray(7.0), jnp.asarray(3.5), num_inference_steps=STEPS,
        max_refs=3, height=PX, width=PX)
    close(frames, ref, "fused story")


def test_bench_story_encodes_without_a_graph(both, monkeypatch):
    """The per-frame story's reference encodes run with no autograd graph
    though the VAE's weights require grad (the JAX script's encode is a
    jitted forward): the refs have no grad_fn, and every 3x3 conv of the
    encoder packed its weight once, into its cache, not differentiably at
    each call."""
    port, _ = both
    vae = port["vae"].requires_grad_(True)
    convs = [m for m in vae.encoder.modules() if isinstance(m, Conv3x3)]
    assert convs
    for m in convs:
        m._packed.clear()
    refs = []
    encode = StoryGenSampler.encode_ref_latents

    def recorded(self, *args):
        refs.append(encode(self, *args))
        return refs[-1]

    monkeypatch.setattr(StoryGenSampler, "encode_ref_latents", recorded)
    bench_story.run(port, steps=STEPS, stories=1, height=PX, device="cpu")
    assert len(refs) == 2 * 3  # frames 2-4 of the warm-up and the story
    assert all(r.grad_fn is None and not r.requires_grad for r in refs)
    assert all(m._packed for m in convs)
