"""Port parity for StoryGenSampler.sample with the multistep samplers,
JAX package against the port on the same inputs and weights (5e-4, the
slice standard of tests/test_torch_port_pipeline.py), 3 steps with 2
refs in the auto-regressive stage: DPM-Solver++(2M) (first-order,
second-order, then x0 past the end) and LMS, whose float timesteps (999,
499.5, 0) reach the UNet's embedding and, floored and truncated, the
reference pass's noise levels."""
import pytest

from tests.torch_port_util import assert_close, sample_both, serving_models


@pytest.fixture(scope="module")
def models():
    return serving_models()


@pytest.mark.parametrize("sampler", ["dpm++", "lms"])
def test_multistep_sample_matches_jax(models, sampler):
    out_j, out_t = sample_both(models, sampler=sampler,
                               stage="auto-regressive", steps=3)
    assert_close(out_j, out_t, atol=5e-4, rtol=5e-4, msg=sampler)


def test_lms_float_timesteps_reach_the_unet(models):
    """The tiny UNet's output moves little with t, so the timesteps it is
    given are held directly: LMS's float t at the main pass, and at the
    reference pass the JAX package's ref_t = t // 10 (floored, in float)
    times N..1; the noise tables are read at the truncated t."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from storygen_tpu.diffusion import schedule as JS
    from storygen_tpu.pipeline import _ref_timesteps
    from storygen_tpu_torch.configs import SchedulerConfig
    from storygen_tpu_torch.diffusion import lms
    from storygen_tpu_torch.diffusion import schedule as S
    from storygen_tpu_torch.pipeline import StoryGenSampler
    from tests.torch_port_util import rand, t

    unet = models["unet"][0]
    seen = []

    def spy(x, ts, *args):
        seen.append(torch.as_tensor(ts).clone())
        return unet(x, ts, *args)

    sampler = StoryGenSampler(unet, models["vae"][0], device="cpu")
    sampler.unet = spy
    lat, txt = (1, 8, 8, 4), (1, 7, 24)
    sampler.sample(t(rand(0, lat)), t(rand(1, txt)), t(rand(2, txt)),
                   t(rand(3, (2,) + lat)), t(rand(4, lat)),
                   t(rand(5, (2,) + txt)), t(rand(6, (2,) + txt)),
                   t(rand(7, lat)), 7.5, 3.5, stage="auto-regressive",
                   num_inference_steps=3, sampler="lms")
    t_eval = lms.lms_tables(SchedulerConfig(), 3)[0]
    assert t_eval[1] == np.float32(499.5)
    assert len(seen) == 6
    for i, tt in enumerate(t_eval):
        ref_ts = np.asarray(_ref_timesteps(
            "auto-regressive", jnp.asarray(tt, jnp.float32) // 10, 2))
        ref_pass, main_pass = seen[2 * i], seen[2 * i + 1]
        assert ref_pass.dtype == main_pass.dtype == torch.float32
        np.testing.assert_array_equal(ref_pass.numpy(),
                                      np.repeat(ref_ts, 2))
        assert main_pass.item() == tt
    # float timesteps index the tables truncated, as astype(int32) does
    table = JS.make_schedule().alphas_cumprod
    ft = np.array([49.0, 98.7, 499.5], np.float32)
    np.testing.assert_array_equal(
        S._gather(S.make_schedule().alphas_cumprod, torch.as_tensor(ft)),
        np.asarray(JS._gather(table, jnp.asarray(ft))))
