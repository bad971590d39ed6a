"""The port's masked-DDIM inpainter (storygen_tpu_torch/data_process/
inpaint.py) against the JAX package's TPUInpainter at the tiny UNet / VAE
/ CLIP widths, fp32, 2 DDIM steps: one parameter set in both
(tests/torch_port_util.py::serving_models), the JAX draws recomputed from
the same keys and fed to the port; inpaint_latents and inpaint_image
within ATOL / RTOL, the unmasked latents and pixels exact, and the latent
mask equal to jax.image.resize's where a mask edge falls between latent
pixels. The JAX inpaint_latents compiles once for the module (both tests
use the 8 x 8 latent of a 64 px image)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storygen_tpu.data_process.inpaint import TPUInpainter
from storygen_tpu_torch.data_process.inpaint import Inpainter, latent_mask
from tests.torch_port_util import (assert_close, rand, serving_models, t,
                                   tokenizer)

STEPS = 2
PROMPT = "a fox in the snow"


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mask(h, w, rows, cols):
    m = np.zeros((h, w), np.float32)
    m[rows, cols] = 1.0
    return m


@pytest.fixture(scope="module")
def both():
    """The models in both packages, and the JAX runs: inpaint_latents on
    seeded latents, and inpaint_image on a seeded 64 px image, both under
    one jit compile."""
    models = serving_models(clip=True)
    unet, junet, up = models["unet"]
    vae, jvae, vp = models["vae"]
    clip, jclip, cp = models["clip"]
    jax_inp = TPUInpainter(junet, jvae)
    params = {"unet": up, "vae": vp}
    d = clip.config.hidden_size
    lat0 = rand(0, (1, 8, 8, 4), 0.5)
    lmask = _mask(8, 8, slice(2, 6), slice(1, 5))[None, :, :, None]
    text = rand(1, (1, 77, d))
    key = jax.random.PRNGKey(5)
    out_lat = jax_inp.inpaint_latents(
        params, jnp.asarray(lat0), jnp.asarray(lmask), jnp.asarray(text), key,
        num_inference_steps=STEPS)
    image = np.random.RandomState(2).rand(64, 64, 3).astype(np.float32)
    mask = _mask(64, 64, slice(20, 45), slice(13, 37))
    img_key = jax.random.PRNGKey(3)
    out_img = jax_inp.inpaint_image(params, cp, jclip, tokenizer, image, mask,
                                    prompt=PROMPT, rng=img_key,
                                    num_inference_steps=STEPS)
    return dict(unet=unet, vae=vae, clip=clip, lat0=lat0, lmask=lmask,
                text=text, key=key, out_lat=np.asarray(out_lat), image=image,
                mask=mask, img_key=img_key, out_img=out_img)


def _start_noise(key, shape):
    """inpaint_latents' draw: normal(split(rng)[0]) (its second key is
    never used)."""
    return t(jax.random.normal(jax.random.split(key)[0], shape, jnp.float32))


def test_inpaint_latents_match_jax(both):
    b = both
    inp = Inpainter(b["unet"], b["vae"], device="cpu")
    lat0 = t(b["lat0"])
    out = inp.inpaint_latents(lat0, t(b["lmask"]), t(b["text"]),
                              _start_noise(b["key"], lat0.shape),
                              num_inference_steps=STEPS)
    assert out.dtype == torch.float32
    assert_close(b["out_lat"], out)
    keep = torch.from_numpy(b["lmask"] == 0).expand_as(out)
    assert torch.equal(out[keep], lat0[keep])  # exact, not close
    assert not torch.allclose(out[~keep], lat0[~keep])


def test_inpaint_image_matches_jax(both):
    """inpaint_image with the JAX call's two draws: the posterior's from
    split(rng)[0], the start's from split(split(rng)[1])[0]."""
    b = both
    inp = Inpainter(b["unet"], b["vae"], device="cpu")
    k_enc, k_loop = jax.random.split(b["img_key"])
    shape = (1, 8, 8, 4)
    post = t(jax.random.normal(k_enc, shape, jnp.float32))
    out = inp.inpaint_image(b["clip"], tokenizer, b["image"], b["mask"],
                            prompt=PROMPT, num_inference_steps=STEPS,
                            posterior_noise=post,
                            latent_noise=_start_noise(k_loop, shape))
    assert out.shape == (64, 64, 3) and out.dtype == np.float32
    assert_close(b["out_img"], out)
    keep = b["mask"] == 0
    np.testing.assert_array_equal(out[keep], b["image"][keep])
    assert not np.allclose(out[~keep], b["image"][~keep])


def test_inpaint_image_draws_from_its_generator(both):
    """Without given draws: the posterior's, then the start's, from the
    generator (seeded 0 when none is given)."""
    b = both
    inp = Inpainter(b["unet"], b["vae"], device="cpu")
    args = (b["clip"], tokenizer, b["image"], b["mask"])
    g = torch.Generator().manual_seed(0)
    post = torch.randn((1, 8, 8, 4), generator=g)
    start = torch.randn((1, 8, 8, 4), generator=g)
    want = inp.inpaint_image(*args, num_inference_steps=1,
                             posterior_noise=post, latent_noise=start)
    np.testing.assert_array_equal(
        inp.inpaint_image(*args, num_inference_steps=1), want)
    np.testing.assert_array_equal(inp.inpaint_image(
        *args, num_inference_steps=1,
        generator=torch.Generator().manual_seed(0)), want)


@pytest.mark.parametrize("rows,cols", [
    (slice(20, 45), slice(13, 37)),   # edges between latent pixels
    (slice(19, 21), slice(4, 5)),     # thinner than a latent pixel
    (slice(0, 64), slice(59, 64)),    # at the image border
    (slice(3, 3), slice(0, 0))])      # empty
def test_latent_mask_equals_jax_resize(rows, cols):
    m = _mask(64, 64, rows, cols)
    want = jax.image.resize(jnp.asarray(m)[None, :, :, None], (1, 8, 8, 1),
                            "linear", antialias=False) > 0
    got = latent_mask(torch.from_numpy(m), (8, 8))
    assert got.shape == (1, 8, 8, 1) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))
