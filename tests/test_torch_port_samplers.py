"""Port parity for the sampler step functions and their tables:
storygen_tpu_torch/diffusion/{schedule,dpm_solver,euler,pndm,lms}.py
against storygen_tpu/diffusion/ on the same random inputs (fp32, 1e-4;
PLMS timesteps exactly, LMS sigmas and coefficients to 1e-6). Each
multistep sampler runs a chain of steps, so its carried state is held
too. Then the errors of the serving entry points: an unknown sampler, eta
> 0 without noise, and fused with reuse_latents."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storygen_tpu.configs import SchedulerConfig as JSchedConfig
from storygen_tpu.diffusion import dpm_solver as JD
from storygen_tpu.diffusion import euler as JE
from storygen_tpu.diffusion import lms as JL
from storygen_tpu.diffusion import pndm as JP
from storygen_tpu.diffusion import schedule as JS
from storygen_tpu_torch.configs import (CLIPTextConfig, SchedulerConfig,
                                        UNetConfig, VAEConfig)
from storygen_tpu_torch.diffusion import dpm_solver as D
from storygen_tpu_torch.diffusion import euler as E
from storygen_tpu_torch.diffusion import lms as L
from storygen_tpu_torch.diffusion import pndm as P
from storygen_tpu_torch.diffusion import schedule as S
from storygen_tpu_torch.models.clip_text import CLIPTextModel
from storygen_tpu_torch.models.unet import UNet2DConditionModel
from storygen_tpu_torch.models.vae import AutoencoderKL
from storygen_tpu_torch.pipeline import StoryGenPipeline
from tests.torch_port_util import assert_close, rand, t, tokenizer

SHAPE = (2, 8, 8, 4)
SCHEDULES = ("scaled_linear", "linear", "squaredcos_cap_v2")


def _scheds(**kw):
    return (JS.make_schedule(JSchedConfig(**kw)),
            S.make_schedule(SchedulerConfig(**kw)))


@pytest.mark.parametrize("beta_schedule", SCHEDULES)
def test_beta_schedules_match_jax(beta_schedule):
    js, ts = _scheds(beta_schedule=beta_schedule)
    assert_close(js.betas, ts.betas, atol=0, rtol=0, msg="betas")
    assert_close(js.alphas_cumprod, ts.alphas_cumprod, atol=0, rtol=0,
                 msg="alphas_cumprod")
    assert_close(js.final_alpha_cumprod, ts.final_alpha_cumprod, atol=0,
                 rtol=0)
    # the table reaches its last entry
    assert ts.alphas_cumprod[-1] < 0.05


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("prediction_type",
                         ["epsilon", "v_prediction", "sample"])
def test_pred_original_sample_matches_jax(prediction_type, clip):
    js, ts = _scheds(prediction_type=prediction_type, clip_sample=clip)
    out, x = rand(1, SHAPE), rand(2, SHAPE, 2.0)
    tt = np.array([981, 3])
    x0_j, eps_j = JS.pred_original_sample(js, jnp.asarray(out),
                                          jnp.asarray(tt), jnp.asarray(x))
    x0_t, eps_t = S.pred_original_sample(ts, t(out), torch.as_tensor(tt),
                                         t(x))
    assert_close(x0_j, x0_t, msg="x0")
    assert_close(eps_j, eps_t, msg="eps")
    if clip:
        assert float(x0_t.abs().max()) <= 1.0


def test_add_noise_and_velocity_match_jax():
    js, ts = _scheds()
    x, z, tt = rand(3, SHAPE), rand(4, SHAPE), np.array([10, 700])
    assert_close(JS.velocity(js, jnp.asarray(x), jnp.asarray(z),
                             jnp.asarray(tt)),
                 S.velocity(ts, t(x), t(z), torch.as_tensor(tt)))
    assert_close(JS.add_noise(js, jnp.asarray(x), jnp.asarray(z),
                              jnp.asarray(tt)),
                 S.add_noise(ts, t(x), t(z), torch.as_tensor(tt)))


@pytest.mark.parametrize("prev_t", [461, -19])
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_ddim_step_with_eta_matches_jax(prediction_type, prev_t):
    js, ts = _scheds(prediction_type=prediction_type)
    out, x, z = rand(5, SHAPE), rand(6, SHAPE), rand(7, SHAPE)
    for eta in (0.0, 0.5, 1.0):
        ref = JS.ddim_step(js, jnp.asarray(out), jnp.asarray(481),
                           jnp.asarray(prev_t), jnp.asarray(x), eta=eta,
                           noise=jnp.asarray(z))
        got = S.ddim_step(ts, t(out), 481, prev_t, t(x), eta=eta,
                          noise=t(z))
        assert_close(ref, got, msg=f"eta {eta}")


def test_ddpm_step_matches_jax():
    """At a scalar t, as the JAX function takes it; t = 0 adds no noise."""
    js, ts = _scheds()
    out, x, z = rand(8, SHAPE), rand(9, SHAPE), rand(10, SHAPE)
    for tt in (999, 500, 1, 0):
        ref = JS.ddpm_step(js, jnp.asarray(out), jnp.asarray(tt),
                           jnp.asarray(x), jnp.asarray(z))
        got = S.ddpm_step(ts, t(out), tt, t(x), t(z))
        assert_close(ref, got, msg=str(tt))
    assert torch.equal(S.ddpm_step(ts, t(out), 0, t(x), t(z)),
                       S.ddpm_step(ts, t(out), 0, t(x), t(z) * 0))


def _eps_chain(n):
    return [rand(100 + i, SHAPE) for i in range(n)]


def test_dpmpp_2m_chain_matches_jax():
    """First-order first step, second-order after it, x0 past the end."""
    js, ts = _scheds()
    cfg = SchedulerConfig()
    tab = S.ddim_timesteps(cfg, 4)
    prev = np.append(tab[1:], tab[-1] - 250)
    x = rand(11, SHAPE)
    xj, sj = jnp.asarray(x), JD.init_state(jnp.asarray(x))
    xt, st = t(x), D.init_state(t(x))
    for i, eps in enumerate(_eps_chain(4)):
        xj, sj = JD.dpmpp_2m_step(js, jnp.asarray(eps), jnp.asarray(tab[i]),
                                  jnp.asarray(prev[i]), xj, sj)
        xt, st = D.dpmpp_2m_step(ts, t(eps), int(tab[i]), int(prev[i]), xt,
                                 st)
        assert_close(xj, xt, msg=f"step {i}")
        assert_close(sj.prev_x0, st.prev_x0, msg=f"x0 {i}")
        assert int(sj.prev_t) == st.prev_t


def test_euler_steps_match_jax():
    js, ts = _scheds()
    x, out, z = rand(12, SHAPE, 10.0), rand(13, SHAPE), rand(14, SHAPE)
    assert_close(JE.sigma_of(js, jnp.asarray(801)), E.sigma_of(ts, 801))
    assert_close(JE.scale_model_input(js, jnp.asarray(x), jnp.asarray(801)),
                 E.scale_model_input(ts, t(x), 801))
    for tt, prev in ((801, 601), (1, -249)):
        args_j = (js, jnp.asarray(out), jnp.asarray(tt), jnp.asarray(prev),
                  jnp.asarray(x))
        args_t = (ts, t(out), tt, prev, t(x))
        assert_close(JE.euler_step(*args_j), E.euler_step(*args_t),
                     msg=f"euler {tt}")
        assert_close(JE.euler_ancestral_step(*args_j, jnp.asarray(z)),
                     E.euler_ancestral_step(*args_t, t(z)),
                     msg=f"euler_a {tt}")


@pytest.mark.parametrize("steps", [1, 2, 5, 50])
def test_plms_timesteps_match_jax_exactly(steps):
    """n+1 entries (the second timestep twice) from n = 2 on."""
    cfg = SchedulerConfig()
    for ref, got in zip(JP.plms_timesteps(JSchedConfig(), steps),
                        P.plms_timesteps(cfg, steps)):
        assert got.dtype == ref.dtype
        assert len(got) == (steps + 1 if steps > 1 else 1)
        np.testing.assert_array_equal(got, ref)


def test_plms_chain_matches_jax():
    """Six counters: the plain transfer, the trapezoid at the same sample,
    the 2-, 3- and 4-step formulas and the steady state."""
    js, ts = _scheds()
    _, t_cf, prev_cf = P.plms_timesteps(SchedulerConfig(), 5)
    x = rand(15, SHAPE)
    xj, sj = jnp.asarray(x), JP.init_state(jnp.asarray(x))
    xt, st = t(x), P.init_state(t(x))
    for i, eps in enumerate(_eps_chain(6)):
        xj, sj = JP.plms_step(js, jnp.asarray(eps), jnp.asarray(i),
                              jnp.asarray(t_cf[i]), jnp.asarray(prev_cf[i]),
                              xj, sj)
        xt, st = P.plms_step(ts, t(eps), i, t_cf[i], prev_cf[i], xt, st)
        assert_close(xj, xt, msg=f"counter {i}")
        assert_close(sj.ets, st.ets, msg=f"ring {i}")
        assert_close(sj.cur_sample, st.cur_sample, msg=f"cur {i}")


@pytest.mark.parametrize("beta_schedule", SCHEDULES)
def test_lms_tables_match_jax(beta_schedule):
    for steps in (2, 7, 50):
        ref = JL.lms_tables(JSchedConfig(beta_schedule=beta_schedule), steps)
        got = L.lms_tables(SchedulerConfig(beta_schedule=beta_schedule),
                           steps)
        np.testing.assert_array_equal(got[0], ref[0])  # float timesteps
        assert got[0].dtype == np.float32 and got[1].dtype == np.float32
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[2], ref[2], rtol=1e-6, atol=1e-6)


def test_lms_chain_matches_jax():
    _, sigmas, coeffs = L.lms_tables(SchedulerConfig(), 5)
    x = rand(16, SHAPE, 14.0)
    xj, sj = jnp.asarray(x), JL.init_state(jnp.asarray(x))
    xt, st = t(x), L.init_state(t(x))
    for i, eps in enumerate(_eps_chain(5)):
        assert_close(JL.scale_model_input(xj, jnp.asarray(sigmas[i])),
                     L.scale_model_input(xt, sigmas[i]), msg=f"input {i}")
        xj, sj = JL.lms_step(jnp.asarray(eps), jnp.asarray(i),
                             jnp.asarray(coeffs[i], jnp.float32), xj, sj)
        xt, st = L.lms_step(t(eps), coeffs[i], xt, st)
        assert_close(xj, xt, msg=f"step {i}")
        assert_close(sj.derivatives, st.derivatives, msg=f"ring {i}")


def test_serving_errors():
    ts = S.make_schedule()
    with pytest.raises(ValueError, match="eta > 0 requires noise"):
        S.ddim_step(ts, t(rand(1, SHAPE)), 501, 481, t(rand(2, SHAPE)),
                    eta=0.5)
    unet = UNet2DConditionModel(UNetConfig(
        block_out_channels=(8, 8, 8, 8), attention_head_dim=2,
        norm_num_groups=2, cross_attention_dim=8))
    vae = AutoencoderKL(VAEConfig(block_out_channels=(4, 4, 4, 4),
                                  layers_per_block=1, norm_num_groups=2))
    clip = CLIPTextModel(CLIPTextConfig(
        num_hidden_layers=1, hidden_size=8, intermediate_size=16,
        num_attention_heads=2))
    pipe = StoryGenPipeline(unet, vae, clip, tokenizer, device="cpu")
    kw = dict(num_inference_steps=2, height=64, width=64)
    with pytest.raises(ValueError, match="unknown sampler 'heun'"):
        pipe("no", ["a fox"], sampler="heun", **kw)
    # without step noise or a generator, eta > 0 and euler_a cannot draw
    z = torch.zeros((1, 8, 8, 4))
    text = torch.zeros((1, 77, 8))
    for sampler, eta in (("ddim", 0.5), ("euler_a", 0.0)):
        with pytest.raises(ValueError, match="need step_noise"):
            pipe.sampler.sample(z, text, text, None, None, None, None, z,
                                7.5, 3.5, stage="no", num_inference_steps=2,
                                sampler=sampler, eta=eta)
    with pytest.raises(ValueError, match="pick one"):
        pipe.generate_story(["a fox"], fused=True, reuse_latents=True, **kw)


def test_negative_prompt_and_images_per_prompt_match_jax():
    """_generate with 2 prompts, a negative prompt each and 2 images per
    prompt (rows [2i, 2i+2) are prompt i's), auto-regressive with 1 ref,
    against the JAX package's _generate on its own draws (5e-4). The
    negative prompt replaces only the main pass's empty caption."""
    import jax

    from storygen_tpu.pipeline import StoryGenPipeline as JPipeline
    from tests.torch_port_util import jax_frame_draws, serving_models
    m = serving_models(clip=True)
    (unet, junet, up), (vae, jvae, vp), (clip, jclip, cp) = (
        m["unet"], m["vae"], m["clip"])
    jpipe = JPipeline(junet, up, jvae, vp, jclip, cp, tokenizer)
    pipe = StoryGenPipeline(unet, vae, clip, tokenizer, device="cpu")
    key = jax.random.PRNGKey(6)
    kw = dict(stage="auto-regressive", prompt=["a fox", "an owl"],
              image_prompt=np.clip(rand(51, (1, 2, 64, 64, 3), 0.3) + 0.5,
                                   0.0, 1.0),
              prev_prompt=[["the den", "the tall tree"]],
              negative_prompt=["blurry photo", "dark"],
              num_images_per_prompt=2, num_inference_steps=2, height=64,
              width=64)
    img_j, lat_j = jpipe._generate(rng=key, **kw)
    img_t, lat_t = pipe._generate(draw=jax_frame_draws(key), **kw)
    assert img_t.shape == (4, 64, 64, 3)
    assert_close(lat_j, lat_t, atol=5e-4, rtol=5e-4, msg="latents")
    assert_close(img_j, img_t, atol=5e-4, rtol=5e-4, msg="images")
    assert not np.array_equal(img_t[0], img_t[1])
